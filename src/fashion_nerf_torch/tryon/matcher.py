"""Learned garment-correspondence matcher; counterpart of
`fashion_nerf.tryon.matcher`.

A two-tower conv net predicts residual offsets to the keypoint-grid TPS
target points from (agnostic person stack, cloth stack); zero output is the
procedural baseline. Its trained weights are the committed
`assets/matcher_synthetic.npz` (flax HWIO kernels, carried into OIHW;
`save_matcher` writes that layout back). The convolutions pad as flax's
"SAME" does and run in full f32 on the card
(`models.conditioned.conv_same`).

`train_matcher` trains it as the reference does: on batches of randomized
procedural pairs, Adam on the mean over the batch of 1 − soft-IoU of the
TPS-warped cloth mask against the person's garment region plus 0.01 × the
mean squared residual, through the differentiable TPS solve and bilinear
sample. The pairs of a batch run one after the other (a loop: each pair's
preprocessing and TPS system is its own).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn

from fashion_nerf_torch.assets import ASSETS_DIR, load_params, save_params
from fashion_nerf_torch.models.conditioned import (conv_same, lecun_normal_,
                                                   load_conv, load_dense)
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

    def _named(self):
        """(flax layer name, module) in the reference's order."""
        return ([(f"{name}_conv{i}", conv)
                 for name, tower in (("person", self.person),
                                     ("cloth", self.cloth))
                 for i, conv in enumerate(tower)]
                + [("mix", self.mix), ("head0", self.head0),
                   ("head1", self.head1)])

    def init_flax_(self, generator: torch.Generator) -> "GarmentMatcher":
        """flax's init of the reference module: LeCun-normal kernels, zero
        biases, and a zero head1 kernel (a fresh matcher is the procedural
        baseline)."""
        for name, layer in self._named():
            if name == "head1":
                nn.init.zeros_(layer.weight)
            else:
                lecun_normal_(layer.weight, layer.weight[0].numel(),
                              generator)
            nn.init.zeros_(layer.bias)
        return self

    def to_flax(self) -> dict:
        """The reference's parameter tree as numpy: {"params": {name:
        {"kernel" (HWIO or (in, out)), "bias"}}}."""
        out = {}
        for name, layer in self._named():
            w = layer.weight.detach().float().cpu()
            kern = w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()
            out[name] = {"kernel": kern.numpy().copy(),
                         "bias": layer.bias.detach().float().cpu().numpy()}
        return {"params": out}


def save_matcher(matcher: GarmentMatcher, path: str = MATCHER_CKPT,
                 meta: dict = None) -> None:
    """Write the matcher's weights in the reference's asset layout."""
    save_params(path, matcher.to_flax(), meta=meta)


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


PAIR_ARRAYS = ("image", "cloth", "cloth_mask", "parse", "keypoints")


def make_batch(seeds, H: int = 64, W: int = 64, device=None) -> dict:
    """The procedural pairs of `seeds`, each array stacked over the batch,
    on `device` (parse int32, the rest f32)."""
    from fashion_nerf_torch.data.viton import synth_viton_pair
    pairs = [synth_viton_pair(H, W, seed=s) for s in seeds]
    return {k: torch.as_tensor(np.stack([p[k] for p in pairs]),
                               device=device).to(
        torch.int32 if k == "parse" else torch.float32)
        for k in PAIR_ARRAYS}


def pair_loss(matcher, image, cloth, cloth_mask, parse, keypoints, H: int,
              W: int):
    """One pair's training loss → (1 − soft-IoU + 0.01·mean((dst −
    dst0)²), soft-IoU): the warped cloth mask against the person's garment
    region, dst0 the keypoint-grid targets."""
    from fashion_nerf_torch.tryon.pipeline import (
        _preprocess_device, keypoint_grid_correspondences)
    pre = _preprocess_device(image, cloth, cloth_mask, parse, keypoints,
                             H=H, W=W)
    _, wm, dst = matched_warp(matcher, pre, cloth, cloth_mask, keypoints, H,
                              W)
    tgt = pre["garment_mask"]
    iou = soft_iou(wm, tgt)
    _, dst0 = keypoint_grid_correspondences(cloth_mask, tgt, keypoints, H, W,
                                            k_rows=K_ROWS)
    return 1.0 - iou + 0.01 * torch.mean((dst - dst0) ** 2), iou


def batch_loss(matcher, arrs: dict, H: int, W: int):
    """The mean of `pair_loss` over a batch (make_batch) → (loss, IoU)."""
    outs = [pair_loss(matcher, *(arrs[k][i] for k in PAIR_ARRAYS), H=H, W=W)
            for i in range(arrs["image"].shape[0])]
    return (torch.stack([o[0] for o in outs]).mean(),
            torch.stack([o[1] for o in outs]).mean())


def train_matcher(steps: int = 200, batch: int = 8, H: int = 64,
                  W: int = 64, lr: float = 3e-4, seed0: int = 1,
                  generator=None, device=None, matcher=None):
    """Train on the randomized procedural distribution → (matcher,
    history). Each step draws `batch` pair seeds from
    np.random.default_rng(seed0), as the reference does; Adam(lr) on the
    batch mean of `pair_loss`. matcher: a GarmentMatcher to start from, else
    a fresh one drawn from `generator` as flax initialises it. Runs on the
    card unless device names the CPU. history: the loss and IoU every
    steps // 10 steps."""
    from fashion_nerf_torch import kernels as K
    device = K.resolve_device(device)
    if matcher is None:
        gen = generator or torch.Generator().manual_seed(0)
        matcher = GarmentMatcher().init_flax_(gen)
    matcher = matcher.to(device).train()
    opt = torch.optim.Adam(matcher.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(seed0)
    history = []
    for i in range(steps):
        seeds = rng.integers(1, 1_000_000, batch).tolist()
        loss, iou = batch_loss(matcher, make_batch(seeds, H, W, device), H,
                               W)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (i + 1) % max(1, steps // 10) == 0:
            history.append({"step": i + 1, "loss": float(loss.detach()),
                            "iou": float(iou.detach())})
    return matcher.eval(), history


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
