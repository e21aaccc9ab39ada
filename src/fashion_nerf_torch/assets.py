"""Committed parameter assets: nested parameter dicts ↔ one flat .npz file.

The port's own copy of `fashion_nerf.assets` (the same file format), so
that the port imports nothing of the JAX package. Each leaf is stored under
its joined key path ("coarse/params/trunk_0/kernel"); scalar metadata rides
along under "__meta__/<name>". The assets live in the repo's `assets/`
directory: the trained flagship weights (`flagship_synthetic.npz`) and the
σ-only proposal net matched to them (`proposal_synthetic.npz`).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

_SEP = "/"
_META = "__meta__" + _SEP

# the repo's assets/ (src/fashion_nerf_torch/assets.py → ../../assets)
ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets")
FLAGSHIP_CKPT = os.path.join(ASSETS_DIR, "flagship_synthetic.npz")


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def save_params(path: str, params: Any, meta: Optional[dict] = None,
                dtype=np.float32) -> None:
    """Write a nested parameter dict to one compressed npz."""
    flat = {k: v.astype(dtype) for k, v in _flatten(params).items()}
    for k, v in (meta or {}).items():
        flat[_META + k] = np.asarray(v)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_params(path: str):
    """→ (params nested dict of np arrays, meta dict). Raises
    FileNotFoundError."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {k[len(_META):]: flat.pop(k) for k in list(flat)
            if k.startswith(_META)}
    return _unflatten(flat), meta


def load_flagship(path: str = FLAGSHIP_CKPT):
    """The committed trained flagship weights (params, meta), or None when
    the file is absent."""
    if not os.path.exists(path):
        return None
    return load_params(path)
