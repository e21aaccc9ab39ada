"""Real-scene parity harness; counterpart of `fashion_nerf.parity` and the
port's own copy of it (the port imports nothing of the JAX package).

The acceptance gate is "PSNR within 0.1 dB of the published baseline, per
scene". The anchors are the canonical NeRF paper's per-scene results
(Mildenhall et al. 2020, Table 4): external anchors, labelled as such.

    python -m fashion_nerf_torch parity --set data.root=/data/nerf_synthetic \
        --set data.dataset=blender --out runs
    # one JSON line per scene dir under root: psnr/ssim against the anchor

`eval` on a single real scene attaches the same anchor row. The per-scene
checkpoints are expected at <out>/<scene>/<config>/ckpt, where `train --out
<out>/<scene>` puts them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional

# canonical per-scene test-set PSNR anchors (dB): Mildenhall et al., ECCV
# 2020, Table 4. External anchors, the same tables as the reference's.
BLENDER_ANCHORS = {
    "chair": 33.00, "drums": 25.01, "ficus": 30.13, "hotdog": 36.18,
    "lego": 32.54, "materials": 29.62, "mic": 32.91, "ship": 28.65,
}
LLFF_ANCHORS = {
    "room": 32.70, "fern": 25.17, "leaves": 20.92, "fortress": 31.16,
    "orchids": 20.36, "flower": 27.40, "trex": 26.80, "horns": 27.45,
}
PARITY_GATE_DB = 0.1


def anchor_for(root: str, dataset: str) -> Optional[float]:
    """PSNR anchor for a scene directory, keyed by its basename."""
    scene = os.path.basename(os.path.normpath(root)).lower()
    table = BLENDER_ANCHORS if dataset == "blender" else (
        LLFF_ANCHORS if dataset == "llff" else {})
    return table.get(scene)


def anchor_row(root: str, dataset: str, psnr: float) -> dict:
    """The comparison fields eval/parity attach to a measured score."""
    anchor = anchor_for(root, dataset)
    if anchor is None:
        return {"anchor_psnr": None}
    delta = psnr - anchor
    return {
        "anchor_psnr": anchor,
        "anchor_source": "Mildenhall2020_T4[EXT]",
        "delta_db": round(delta, 3),
        "parity": bool(delta >= -PARITY_GATE_DB),
    }


def scene_dirs(root: str, dataset: str):
    """Scene subdirectories of a dataset root, filtered to known layouts:
    blender scenes carry transforms_train.json, LLFF scenes poses_bounds.npy.
    A root that IS a single scene yields just itself."""
    marker = ("transforms_train.json" if dataset == "blender"
              else "poses_bounds.npy")
    if os.path.exists(os.path.join(root, marker)):
        return [root]
    out = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and os.path.exists(os.path.join(d, marker)):
            out.append(d)
    return out


def run_parity(cfg, eval_scene_fn) -> list:
    """Sweep every scene under cfg.data.root with eval_scene_fn(scene_cfg) →
    (psnr, ssim); emit one table row per scene plus a summary line. Returns
    the rows. eval_scene_fn is injected, so the sweep can be tested without
    scene data or a device."""
    dirs = scene_dirs(cfg.data.root, cfg.data.dataset)
    if not dirs:
        print(json.dumps({"error": "no scenes found",
                          "root": cfg.data.root,
                          "dataset": cfg.data.dataset}), file=sys.stderr)
        return []
    rows = []
    for d in dirs:
        scene_cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, root=d))
        psnr, ssim = eval_scene_fn(scene_cfg)
        row = {"scene": os.path.basename(os.path.normpath(d)),
               "psnr": round(psnr, 3), "ssim": round(ssim, 4),
               **anchor_row(d, cfg.data.dataset, psnr)}
        rows.append(row)
        print(json.dumps(row))
    anchored = [r for r in rows if r.get("anchor_psnr") is not None]
    summary = {
        "scenes": len(rows),
        "mean_psnr": round(sum(r["psnr"] for r in rows) / len(rows), 3),
        "anchored": len(anchored),
        "parity_pass": sum(1 for r in anchored if r["parity"]),
        "gate_db": PARITY_GATE_DB,
    }
    print(json.dumps(summary))
    return rows
