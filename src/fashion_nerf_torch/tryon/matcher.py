"""Learned garment-correspondence matcher, inference only; counterpart of
`fashion_nerf.tryon.matcher`.

A two-tower conv net predicts residual offsets to the keypoint-grid TPS
target points from (agnostic person stack, cloth stack); zero output is the
procedural baseline. Its trained weights are the committed
`assets/matcher_synthetic.npz` (flax HWIO kernels, carried into OIHW). The
convolutions pad as flax's "SAME" does and run in full f32 on the card
(`models.conditioned.conv_same`). Training the matcher is not ported
(ROADMAP Queue 1 #11).
"""

from __future__ import annotations

import functools
import os

import torch
from torch import nn

from fashion_nerf_torch.assets import ASSETS_DIR, load_params
from fashion_nerf_torch.models.conditioned import (conv_same, load_conv,
                                                   load_dense)
from fashion_nerf_torch.tryon.tps import fit_tps, grid_sample, tps_grid

K_ROWS = 6                      # as keypoint_grid_correspondences
N_PTS = 3 * K_ROWS
RESIDUAL_SCALE = 0.25           # max |offset| in [-1, 1] units
MATCHER_CKPT = os.path.join(ASSETS_DIR, "matcher_synthetic.npz")


class GarmentMatcher(nn.Module):
    """Two-tower conv matcher → (N_PTS, 2) residual target offsets."""

    def __init__(self, width: int = 32):
        super().__init__()
        chans = (width, width, 2 * width)

        def tower(c_in):
            ins = (c_in,) + chans[:-1]
            return nn.ModuleList(nn.Conv2d(i, o, 3, stride=2, padding=0)
                                 for i, o in zip(ins, chans))

        self.person = tower(5)
        self.cloth = tower(4)
        self.mix = nn.Conv2d(4 * width, 2 * width, 3, stride=1, padding=0)
        self.head0 = nn.Linear(2 * width, 2 * width)
        self.head1 = nn.Linear(2 * width, N_PTS * 2)

    def forward(self, person_feats, cloth_feats):
        """person_feats (H, W, 5): agnostic rgb ⊕ garment mask ⊕ pose map;
        cloth_feats (H, W, 4): cloth rgb ⊕ cloth mask → (N_PTS, 2)."""
        def run(tower, x):
            h = x.permute(2, 0, 1)[None]
            for conv in tower:
                h = torch.relu(conv_same(conv, h))
            return h

        h = torch.cat([run(self.person, person_feats),
                       run(self.cloth, cloth_feats)], dim=1)
        h = torch.relu(conv_same(self.mix, h)).mean(dim=(2, 3))
        h = torch.relu(self.head0(h))
        return RESIDUAL_SCALE * torch.tanh(self.head1(h).reshape(N_PTS, 2))

    def load_flax(self, tree: dict) -> "GarmentMatcher":
        p = tree.get("params", tree)
        for name, tower in (("person", self.person), ("cloth", self.cloth)):
            for i, conv in enumerate(tower):
                load_conv(conv, p[f"{name}_conv{i}"])
        load_conv(self.mix, p["mix"])
        load_dense(self.head0, p["head0"])
        load_dense(self.head1, p["head1"])
        return self


@functools.lru_cache(maxsize=4)
def _load_cached(path: str, mtime: float, device: str):
    params, _ = load_params(path)
    return GarmentMatcher().load_flax(params).to(device).eval()


def load_matcher(path: str = "", device=None):
    """The committed matcher on `device` (default the CPU), or None when
    the asset is absent (the procedural keypoint-grid warp, the matcher's
    zero-residual limit). Cached per (path, mtime, device)."""
    path = path or MATCHER_CKPT
    if not os.path.exists(path):
        return None
    return _load_cached(path, os.path.getmtime(path),
                        str(torch.device(device or "cpu")))


def _pair_features(pre: dict, cloth, cloth_mask):
    person = torch.cat([pre["agnostic"], pre["garment_mask"][..., None],
                        pre["pose_heat"].amax(dim=-1, keepdim=True)], dim=-1)
    return person, torch.cat([cloth, cloth_mask[..., None]], dim=-1)


def matched_warp(matcher, pre: dict, cloth, cloth_mask, keypoints, H: int,
                 W: int):
    """Warp `cloth` with the keypoint-grid correspondences plus the
    matcher's residual on the targets (matcher None: the procedural
    baseline) → (warped_cloth, warped_mask, dst)."""
    from fashion_nerf_torch.tryon.pipeline import \
        keypoint_grid_correspondences
    src, dst = keypoint_grid_correspondences(
        cloth_mask, pre["garment_mask"], keypoints, H, W, k_rows=K_ROWS)
    if matcher is not None:
        dst = dst + matcher(*_pair_features(pre, cloth, cloth_mask))
    grid = tps_grid(fit_tps(dst, src), H, W)
    warped_cloth = grid_sample(cloth, grid, padding_value=1.0)
    warped_mask = grid_sample(cloth_mask[..., None], grid)[..., 0]
    return warped_cloth, warped_mask, dst


def soft_iou(a, b, eps: float = 1e-6):
    return torch.sum(a * b) / (torch.sum(a + b - a * b) + eps)


def _device_pair(pair: dict, H: int, W: int, device=None) -> dict:
    from fashion_nerf_torch.tryon.pipeline import _preprocess_device, to_device
    return _preprocess_device(*to_device(pair, device), H=H, W=W)


def eval_iou(matcher, seeds, H: int = 64, W: int = 64, device=None):
    """Mean warped-mask IoU over held-out procedural pairs → (learned,
    keypoint-grid baseline)."""
    from fashion_nerf_torch.data.viton import synth_viton_pair
    from fashion_nerf_torch.tryon.pipeline import to_device

    def one(pair):
        pre = _device_pair(pair, H, W, device)
        _, cloth, cm, _, kp = to_device(pair, device)
        tgt = (pre["garment_mask"] > 0.5).float()
        _, wm_l, _ = matched_warp(matcher, pre, cloth, cm, kp, H, W)
        _, wm_b, _ = matched_warp(None, pre, cloth, cm, kp, H, W)
        return (float(soft_iou((wm_l > 0.5).float(), tgt)),
                float(soft_iou((wm_b > 0.5).float(), tgt)))

    with torch.no_grad():
        scores = [one(synth_viton_pair(H, W, seed=s)) for s in seeds]
    return (sum(s[0] for s in scores) / len(scores),
            sum(s[1] for s in scores) / len(scores))
