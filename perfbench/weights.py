"""The weights of a cell, made by the benchmark and handed to both sides.

A configuration document's "weights" group says where they come from:

- {"kind": "assets", "nets": {net: ["<repo path>.npz", "<prefix>"]}}:
  committed parameter files (keys "<prefix>/params/<layer>/kernel", or
  "params/<layer>/kernel" for the prefix ""); the render's program loads
  its own copy through its set-up, a training program takes these arrays,
  and the reference reads the files.
- {"kind": "seeded"}: the nets the "config" group's "model" describes,
  "coarse" and (with fine samples) "fine", drawn from the run's seed on
  the device in one call: LeCun-normal kernels truncated at ±2σ (the
  program's own initialisation), zero biases, float32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import ROOT


def load_npz_tree(path: str) -> dict:
    """{net: {"params": {layer: {"kernel", "bias"}}}} of a committed npz,
    metadata ("__meta__/…") left out."""
    tree: dict = {}
    with np.load(os.path.join(ROOT, path)) as z:
        for key in z.files:
            if key.startswith("__meta__"):
                continue
            node = tree
            *head, leaf = key.split("/")
            for p in head:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def layer_shapes(model: dict) -> list:
    """[(layer, rows, cols)] of the NeRF MLP a "model" group describes."""
    cx = 3 * (2 * model["posenc_xyz"] + 1)
    W, out = model["net_width"], []
    for i in range(model["net_depth"]):
        rows = cx if i == 0 else W + (cx if (i - 1) in model["skips"] else 0)
        out.append((f"trunk_{i}", rows, W))
    if model["use_viewdirs"]:
        cd = 3 * (2 * model["posenc_dir"] + 1)
        out += [("sigma_head", W, 1), ("feature", W, W),
                ("view_0", W + cd, W // 2), ("rgb_head", W // 2, 3)]
    else:
        out.append(("out_head", W, 4))
    return out


def seeded_trees(cfg: dict, seed: int, device) -> dict:
    """{"coarse", "fine"}: nets of the configuration's model, on device."""
    names = ["coarse"] + (["fine"] if cfg["sampling"]["n_fine"] > 0 else [])
    shapes = layer_shapes(cfg["model"])
    n = sum(r * c for _, r, c in shapes) * len(names)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    trees, at = {}, 0
    for name in names:
        params = {}
        for layer, rows, cols in shapes:
            std = (1.0 / rows) ** 0.5 / 0.87962566103423978
            k = flat[at:at + rows * cols].view(rows, cols) * std
            at += rows * cols
            params[layer] = {"kernel": k,
                             "bias": torch.zeros(cols, device=device)}
        trees[name] = {"params": params}
    return trees


def cell_trees(cfg_doc: dict, seed: int, device) -> dict:
    """The parameter trees of a configuration document for this seed."""
    w = cfg_doc["weights"]
    if w["kind"] == "assets":
        out = {}
        for net, (path, prefix) in w["nets"].items():
            tree = load_npz_tree(path)
            out[net] = tree[prefix] if prefix else tree
        return out
    if w["kind"] == "seeded":
        return seeded_trees(cfg_doc["config"], seed, device)
    raise ValueError(f"weights kind {w['kind']!r}")
