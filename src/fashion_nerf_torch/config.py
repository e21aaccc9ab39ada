"""The port's configuration tree: frozen dataclasses, the presets and
dotted `--set a.b=c` overrides.

The port's own copy of `fashion_nerf.config`, with the same field names,
defaults and five presets (tests/test_torch_config_assets.py holds every
one equal to the reference's), so that the port imports nothing of the JAX
package. The port adds the `mipnerf360` preset and the model fields it
needs (`ipe_deg`, `bottleneck_width`, `view_width`); `ipe_deg` = 0 leaves
the five presets rendering as the reference's, and only mip-NeRF 360's nets
read the two widths; the train fields after `occ_fine` (mip-NeRF 360's
optimizer and losses) default to what the reference's presets train
with. Why each preset's values were chosen is written beside
the reference's copy. The kernel fields `use_pallas`, `fused_mlp`,
`fused_backward`, `fused_render` and `blockwise` choose among the
reference's paths (the fused field or the module's own, the fused render or
`volume_render`, the blockwise march or the dense renderer), each read by
the predicates after `Config` alone; the device then chooses the kernel or
its plain version (kernels/__init__.py). `interpret` and `mlp_dtype` are
kept for equality and read by nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, replace
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    net_depth: int = 8            # trunk layers
    net_width: int = 256          # trunk width
    skips: Tuple[int, ...] = (4,)  # concat γ(x) after trunk layer i (input to i+1)
    posenc_xyz: int = 10          # L for positions → 3+3*2*10 = 63 dims
    posenc_dir: int = 4           # L for view dirs → 3+3*2*4 = 27 dims
    use_viewdirs: bool = True
    sigma_activation: str = "relu"   # relu | softplus
    compute_dtype: str = "float32"   # activation/matmul dtype (params stay f32)
    conditioned: bool = False
    condition_dim: int = 64       # garment feature dim injected into the trunk
    n_latents: int = 0            # 0 = no latent table
    latent_dim: int = 32
    # mip-NeRF 360 (render/m360.py): > 0 takes the integrated encoding of
    # contracted cone Gaussians of this degree in place of γ(x), and the
    # nets of models/mipnerf360.py; 0 = the NeRF MLP above
    ipe_deg: int = 0
    bottleneck_width: int = 256   # its NeRF MLP's feature layer
    view_width: int = 128         # its one view layer


@dataclass(frozen=True)
class SamplingConfig:
    n_coarse: int = 64
    n_fine: int = 0               # 0 = coarse-only
    perturb: bool = True          # stratified jitter during training
    lindisp: bool = False         # sample linearly in inverse depth
    raw_noise_std: float = 0.0    # σ-pre-activation noise during training


@dataclass(frozen=True)
class RenderConfig:
    near: float = 2.0
    far: float = 6.0
    ndc: bool = False             # LLFF forward-facing reparameterization
    white_bkgd: bool = False
    chunk: int = 16384            # rays per device dispatch when rendering images
    eval_n_coarse: int = 0
    eval_n_fine: int = 0


@dataclass(frozen=True)
class OccupancyConfig:
    """Empty-space culling from a trained field (core/occupancy.py)."""
    enabled: bool = False
    resolution: int = 64          # lattice cells per axis (one-time G³ σ sweep)
    sigma_threshold: float = 1e-2  # post-activation density for "occupied"
    margin_cells: int = 1         # conservative AABB dilation (cells)
    margin_world: float = 0.0625
    macro: int = 4
    world_min: float = -2.0
    world_max: float = 2.0
    sample_warp: bool = False
    warp_bins: int = 64           # indicator bins over the union interval


@dataclass(frozen=True)
class ProposalConfig:
    """The σ-only proposal field of the render-time coarse pass."""
    enabled: bool = False
    net_depth: int = 2            # proposal trunk layers
    net_width: int = 128          # proposal trunk width (lane-friendly)
    posenc_xyz: int = 6           # proposal position encoding L
    eval_n: int = 64
    union: bool = False
    cov_n: int = 0
    dilate: int = 2
    uniform_mix: float = 0.2
    edge_bins: bool = True
    cull_acc: float = 0.0
    block_samples: int = 0
    sigma_march: bool = True
    distill_steps: int = 2000
    distill_batch: int = 8192
    distill_lr: float = 2e-3


@dataclass(frozen=True)
class KernelConfig:
    """Kernel selection and the blockwise march's settings."""
    use_pallas: bool = False
    fused_mlp: bool = True
    fused_render: bool = True
    mlp_dtype: str = "bfloat16"   # matmul input dtype inside fused MLP (accum f32)
    fused_backward: bool = True
    interpret: bool = False
    blockwise: bool = True
    block_samples: int = 32       # samples per block (tile = 2048/SB rays)
    early_term_eps: float = 1e-4  # stop marching when transmittance < ε (0 = off)
    fused_carry: bool = False
    carry_hoist: bool = True


@dataclass(frozen=True)
class TrainConfig:
    iters: int = 200_000
    batch_rays: int = 4096        # rays per step (global, sharded over dp axis)
    lr_init: float = 5e-4
    lr_final: float = 5e-5
    lr_decay_steps: int = 250_000
    seed: int = 0
    log_every: int = 100
    eval_every: int = 5000
    ckpt_every: int = 10000
    ckpt_keep: int = 3
    precrop_iters: int = 0        # train on center crop for first N iters
    precrop_frac: float = 0.5
    sparsity_weight: float = 0.0
    sparsity_points: int = 1024   # random world points per step
    occ_train: bool = False
    occ_refresh_every: int = 500
    occ_warmup: int = 1000
    occ_dense_every: int = 8
    occ_coarse: int = 32          # reduced budget inside tight ranges
    occ_fine: int = 64
    # mip-NeRF 360's optimizer and losses: Adam's ε, the warm-up and the
    # clipping (train/state.py), the loss terms (train/m360.py); the
    # defaults leave every other preset's training as it is
    adam_eps: float = 1e-8
    lr_delay_steps: int = 0       # warm-up steps of the learning rate
    lr_delay_mult: float = 1.0    # the warm-up's starting multiplier
    grad_max_norm: float = 0.0    # clip the global gradient norm (0 = off)
    charbonnier_eps: float = 0.0  # ε of the data term √(d² + ε²)
    interlevel_weight: float = 0.0
    distortion_weight: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "tiny"         # tiny | blender | llff | viton
    root: str = ""
    stream: bool = False
    half_res: bool = False
    llff_factor: int = 8
    llff_spherify: bool = False
    frame_ids: Tuple[int, ...] = ()   # dynamic try-on: which frames carry latents


@dataclass(frozen=True)
class TryonConfig:
    use_matcher: bool = True
    matcher_asset: str = ""


@dataclass(frozen=True)
class DistConfig:
    dp: int = -1                  # data-parallel axis size; -1 = all devices
    tp: int = 1                   # optional tensor parallel over MLP hidden dim
    multihost: bool = False     


@dataclass(frozen=True)
class Config:
    name: str = "tiny_lego"
    model: ModelConfig = field(default_factory=ModelConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    occupancy: OccupancyConfig = field(default_factory=OccupancyConfig)
    proposal: ProposalConfig = field(default_factory=ProposalConfig)
    kernels: KernelConfig = field(default_factory=KernelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    tryon: TryonConfig = field(default_factory=TryonConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    out_dir: str = "runs"


def takes_fused_field(cfg: Config, training: bool = False) -> bool:
    """Whether the NeRFMLPs run through the fused field (K3, and K4 as its
    backward in training) rather than the module's own field: for
    inference, or for training (`kernels.fused_backward` as well)."""
    k = cfg.kernels
    return bool(k.use_pallas and k.fused_mlp
                and (not training or k.fused_backward))


def asks_blockwise(cfg: Config) -> bool:
    """Whether the config asks for the blockwise march."""
    return bool(cfg.kernels.use_pallas and cfg.kernels.blockwise)


def takes_blockwise(cfg: Config) -> bool:
    """Whether whole-image renders take the blockwise march
    (render/blockwise.py): asked for, through the fused field, with a fine
    pass. Otherwise the dense renderer serves."""
    return (asks_blockwise(cfg) and takes_fused_field(cfg)
            and cfg.sampling.n_fine > 0)


def is_mipnerf360(cfg) -> bool:
    """Whether the config's nets are mip-NeRF 360's (`model.ipe_deg` > 0):
    its state, step, eval and render. A config tree without the field (the
    reference's, which tests hand the port) is not."""
    return getattr(cfg.model, "ipe_deg", 0) > 0


def train_setting(cfg, name: str):
    """A `train` field of the port's (mip-NeRF 360's optimizer and losses),
    its default in a config tree that lacks it (the reference's)."""
    return getattr(cfg.train, name, getattr(TrainConfig, name))


def takes_fused_render(cfg: Config) -> bool:
    """Whether the dense renderer's unculled evaluation composites through
    the fused render (K5) rather than `volume_render`."""
    return bool(cfg.kernels.use_pallas and cfg.kernels.fused_render)


# --- The five acceptance presets (BASELINE.json:7-11), and mip-NeRF 360 ------

PRESETS: dict = {}


def _register(cfg: Config) -> Config:
    PRESETS[cfg.name] = cfg
    return cfg


_register(Config(
    name="tiny_lego",
    model=ModelConfig(posenc_xyz=6, posenc_dir=4, use_viewdirs=False),
    sampling=SamplingConfig(n_coarse=64, n_fine=0),
    render=RenderConfig(near=2.0, far=6.0, white_bkgd=True, chunk=4096),
    train=TrainConfig(iters=1000, batch_rays=1024, lr_init=5e-4, lr_final=5e-5,
                      lr_decay_steps=1000, eval_every=250, ckpt_every=500),
    data=DataConfig(dataset="tiny"),
))

_register(Config(
    name="blender_lego",
    model=ModelConfig(compute_dtype="bfloat16"),
    sampling=SamplingConfig(n_coarse=64, n_fine=128, raw_noise_std=0.0),
    render=RenderConfig(near=2.0, far=6.0, white_bkgd=True, chunk=8192,
                        eval_n_coarse=32, eval_n_fine=96),
    occupancy=OccupancyConfig(enabled=True, sigma_threshold=0.1, macro=8,
                              margin_world=0.125),
    proposal=ProposalConfig(enabled=True, cull_acc=5e-4, block_samples=64),
    kernels=KernelConfig(use_pallas=True, fused_carry=True,
                         early_term_eps=1e-3),
    train=TrainConfig(iters=200_000, batch_rays=4096, precrop_iters=500,
                      sparsity_weight=1e-4,
                      occ_train=True),
    data=DataConfig(dataset="blender"),
))

_register(Config(
    name="llff_fern",
    model=ModelConfig(),
    sampling=SamplingConfig(n_coarse=64, n_fine=128, raw_noise_std=1.0,
                            lindisp=False),
    render=RenderConfig(near=0.0, far=1.0, ndc=True, white_bkgd=False,
                        chunk=32768),
    occupancy=OccupancyConfig(enabled=False, world_min=-1.0, world_max=1.0),
    kernels=KernelConfig(use_pallas=True),
    train=TrainConfig(iters=200_000, batch_rays=4096),
    data=DataConfig(dataset="llff", llff_factor=8),
))

_register(Config(
    name="viton_tryon",
    model=ModelConfig(conditioned=True, condition_dim=64),
    sampling=SamplingConfig(n_coarse=64, n_fine=128),
    render=RenderConfig(near=2.0, far=6.0, white_bkgd=True, chunk=16384,
                        eval_n_coarse=32, eval_n_fine=96),
    occupancy=OccupancyConfig(enabled=True),
    proposal=ProposalConfig(enabled=True, cull_acc=5e-4, block_samples=64),
    kernels=KernelConfig(use_pallas=True, fused_carry=True,
                         early_term_eps=1e-3),
    train=TrainConfig(iters=100_000, batch_rays=2048, sparsity_weight=1e-4),
    data=DataConfig(dataset="viton"),
))

_register(Config(
    name="dynamic_tryon",
    model=ModelConfig(conditioned=True, condition_dim=64,
                      n_latents=64, latent_dim=32),
    sampling=SamplingConfig(n_coarse=64, n_fine=128),
    render=RenderConfig(near=2.0, far=6.0, white_bkgd=True, chunk=16384,
                        eval_n_coarse=32, eval_n_fine=96),
    occupancy=OccupancyConfig(enabled=True),
    proposal=ProposalConfig(enabled=True, cull_acc=5e-4, block_samples=64),
    kernels=KernelConfig(use_pallas=True, fused_carry=True,
                         early_term_eps=1e-3),
    train=TrainConfig(iters=100_000, batch_rays=2048, sparsity_weight=1e-4),
    data=DataConfig(dataset="tiny", frame_ids=tuple(range(64))),
))


# mip-NeRF 360 (Barron et al., CVPR 2022) at its published widths: an 8×1024
# NeRF MLP with a skip after layer 4, a 256-wide bottleneck and one 128-wide
# view layer; a 4×256 σ-only proposal MLP evaluated twice on 64 intervals
# each, then 32 for the NeRF MLP; samples spaced in disparity (g = 1/x)
# from near 0.2 to far 1e6, IPE degree 12, view encoding degree 4. Training
# as published (§4): 2^14 rays a step, the Charbonnier data term (ε 1e-3),
# the interlevel loss (weight 1) and the distortion loss (weight 0.01),
# Adam (0.9, 0.999, ε 1e-6) on a log-linear rate from 2e-3 to 2e-5 over
# 250,000 steps after a 512-step warm-up (the public code's sine ramp from
# 1e-8), gradients clipped to a global norm of 1e-3.
_register(Config(
    name="mipnerf360",
    model=ModelConfig(net_depth=8, net_width=1024, skips=(4,), posenc_dir=4,
                      use_viewdirs=True, sigma_activation="softplus",
                      compute_dtype="bfloat16", ipe_deg=12),
    sampling=SamplingConfig(n_coarse=64, n_fine=32, perturb=False,
                            lindisp=True),
    render=RenderConfig(near=0.2, far=1e6, white_bkgd=True, chunk=65536),
    proposal=ProposalConfig(enabled=True, net_depth=4, net_width=256,
                            eval_n=64),
    kernels=KernelConfig(use_pallas=True),
    train=TrainConfig(iters=250_000, batch_rays=16384, lr_init=2e-3,
                      lr_final=2e-5, lr_decay_steps=250_000,
                      lr_delay_steps=512, lr_delay_mult=1e-8, adam_eps=1e-6,
                      grad_max_norm=1e-3, charbonnier_eps=1e-3,
                      interlevel_weight=1.0, distortion_weight=0.01),
    data=DataConfig(dataset="llff", llff_factor=4),
))


# --- dotted overrides --------------------------------------------------------

def _set_dotted(cfg: Any, dotted: str, raw: str) -> Any:
    """Return a copy of `cfg` with dotted path (e.g. 'train.iters') set.

    Values are parsed with the target field's existing type.
    """
    head, _, rest = dotted.partition(".")
    names = {f.name: f for f in fields(cfg)}
    if head not in names:
        raise KeyError(f"unknown config field {head!r} on {type(cfg).__name__}")
    cur = getattr(cfg, head)
    if rest:
        return replace(cfg, **{head: _set_dotted(cur, rest, raw)})
    new_val = _parse_like(cur, raw)
    return replace(cfg, **{head: new_val})


def _parse_like(template: Any, raw: str) -> Any:
    if isinstance(template, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(template, int):
        return int(raw)
    if isinstance(template, float):
        return float(raw)
    if isinstance(template, tuple):
        if raw.strip() == "":
            return ()
        items = [s.strip() for s in raw.split(",")]
        inner = template[0] if template else int
        return tuple(type(inner)(s) if template else int(s) for s in items)
    return raw


def load_config(name: str, overrides: Optional[list] = None) -> Config:
    """Look up a preset and apply `k=v` dotted overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    for item in overrides or []:
        key, _, val = item.partition("=")
        cfg = _set_dotted(cfg, key.strip(), val.strip())
    return cfg


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg
