"""σ-only proposal field; counterpart of `fashion_nerf.models.proposal`.

A 2×128 σ-only MLP (posenc L=6) shapes the fine-pass PDF at render time in
place of the full coarse network. The port loads it from the committed
asset (assets/proposal_synthetic.npz), matched to the fine weights by the
reference's sha256 teacher signature. Distillation is not ported yet.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from fashion_nerf_torch.assets import ASSETS_DIR, _flatten, load_params
from fashion_nerf_torch.config import Config, ModelConfig
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP, load_flax_params

PROPOSAL_ASSET = os.path.join(ASSETS_DIR, "proposal_synthetic.npz")


def proposal_model_config(cfg: Config) -> ModelConfig:
    """The proposal net as a ModelConfig: no view branch, no cond, no skip."""
    p = cfg.proposal
    return ModelConfig(
        net_depth=p.net_depth, net_width=p.net_width, skips=(),
        posenc_xyz=p.posenc_xyz, posenc_dir=4, use_viewdirs=False,
        sigma_activation=cfg.model.sigma_activation,
        compute_dtype=cfg.model.compute_dtype,
        conditioned=False, n_latents=0)


def _teacher_signature(fine_params) -> str:
    """sha256 over every leaf's f32 bytes in path-sorted order (key path
    bytes first), exactly as the reference computes it. Takes the
    reference's parameter tree or a NeRFMLP."""
    if isinstance(fine_params, NeRFMLP):
        fine_params = fine_params.to_flax_params()
    flat = _flatten(fine_params)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(
            np.asarray(flat[k], dtype=np.float32)).tobytes())
    return h.hexdigest()


def attach_proposal(cfg: Config, params: dict, path: str = PROPOSAL_ASSET,
                    device=None) -> dict:
    """Return a copy of `params` with "proposal" (a NeRFMLP) attached from
    the committed asset. Raises when the asset is missing or was distilled
    for another config or other fine weights: distillation of a new
    proposal is ROADMAP Queue 1 #13 and is not ported."""
    if not (cfg.proposal.enabled and cfg.sampling.n_fine > 0
            and "fine" in params):
        return params
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"proposal asset {path} missing; distillation is not ported "
            "(ROADMAP Queue 1 #13)")
    prop, meta = load_params(path)
    sig = _teacher_signature(params["fine"])
    want = {"config": cfg.name, "teacher_sig": sig,
            "net_depth": cfg.proposal.net_depth,
            "net_width": cfg.proposal.net_width,
            "posenc": cfg.proposal.posenc_xyz}
    got = {k: (str(meta.get(k, "")) if isinstance(v, str)
               else int(meta.get(k, -1))) for k, v in want.items()}
    if got != want:
        bad = sorted(k for k in want if got[k] != want[k])
        raise ValueError(
            f"proposal asset {path} does not match these fine weights / "
            f"config (mismatch in {bad}); distilling a new proposal is not "
            "ported (ROADMAP Queue 1 #13)")
    if device is None and isinstance(params["fine"], NeRFMLP):
        device = next(params["fine"].parameters()).device
    return {**params, "proposal": load_flax_params(
        prop, compute_dtype=cfg.model.compute_dtype, device=device)}
