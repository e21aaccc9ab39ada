"""The blockwise branches that the generic carry march serves, against the
JAX reference on the flagship weights: `kernels.carry_hoist=false` (the
fine march through K6's plain version) and the full coarse march without
a proposal net, through either march, end to end on rays and on a frame.
The reference runs its Pallas marches in interpret mode on the CPU; both
sides take the reference's occupancy state, so they make the same culling
decisions. Bound: ≥ 40 dB, the reference's own hoisted-against-generic
bound (tests/kernels/test_slimmarch.py:184-202)."""

import functools

import jax
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config
from fashion_nerf.core.cameras import generate_rays as j_rays
from fashion_nerf.core.occupancy import build_from_config as j_occ_build
from fashion_nerf.models.nerf_mlp import make_field
from fashion_nerf.models.proposal import attach_proposal as j_attach
from fashion_nerf.render import blockwise as jbw
from fashion_nerf_torch.core.occupancy import OccupancyState
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)

H = W = 32
FOCAL = 0.5 * W / np.tan(0.5 * 0.6911)      # the bench framing at 32×32
IMG = 40          # a wider 40×40 view: pad rays and dead chunks


def _c2w():
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return c2w


def _cfg(*ovr):
    return load_config("blender_lego", ["kernels.interpret=true",
                                        "occupancy.resolution=32", *ovr])


@pytest.fixture(scope="module")
def scene():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    params, _ = loaded
    cfg = _cfg()
    _, field = make_field(cfg.model)
    occ_j = j_occ_build(cfg, functools.partial(field, params["fine"]))
    params_j = j_attach(cfg, dict(params), occ=occ_j, allow_distill=False)
    nets = {k: load_flax_params(params[k], compute_dtype="bfloat16")
            for k in ("coarse", "fine")}
    params_t = attach_proposal(cfg, nets)
    occ_t = OccupancyState(*[torch.tensor(np.asarray(x)) for x in occ_j])
    return params_j, occ_j, params_t, occ_t


def _rays():
    """256 rays across the object (rows 12-19 of the 32×32 frame)."""
    ro, rd = j_rays(H, W, FOCAL, _c2w())
    return (np.asarray(ro).reshape(-1, 3)[384:640],
            np.asarray(rd).reshape(-1, 3)[384:640])


def _both(scene, cfg, with_proposal=True):
    params_j, occ_j, params_t, occ_t = scene
    if not with_proposal:
        params_j = {k: params_j[k] for k in ("coarse", "fine")}
        params_t = {k: params_t[k] for k in ("coarse", "fine")}
    ro, rd = _rays()
    out_j = jbw.render_rays_blockwise(params_j, cfg, *map(jax.numpy.asarray,
                                                          (ro, rd, rd)),
                                      occ=occ_j)
    with torch.no_grad():
        out_t = tbw.render_rays_blockwise(params_t, cfg, torch.tensor(ro),
                                          torch.tensor(rd), torch.tensor(rd),
                                          occ=occ_t)
    return out_j, out_t


def _psnr(out_t, out_j, key="fine"):
    return float(psnr(out_t[key]["rgb"],
                      torch.tensor(np.asarray(out_j[key]["rgb"]))))


def test_carry_hoist_false_matches_reference(scene):
    """Proposal (K1) + fine march through K6's plain version."""
    out_j, out_t = _both(scene, _cfg("kernels.carry_hoist=false"))
    p = _psnr(out_t, out_j)
    assert p >= 40.0, p
    acc = out_t["fine"]["acc"].numpy()
    assert acc.max() > 0.9 and acc.min() == 0.0    # surface and misses


@pytest.mark.parametrize("hoist", ["true", "false"])
def test_no_proposal_matches_reference(scene, hoist):
    """Without a proposal net: the full coarse march of the coarse net (32
    samples under occupancy) and the fine march over the coarse samples
    joined with 96 from the mid-bin PDF (128 = four blocks), through K2
    (carry_hoist=true) or K6 (false); coarse and fine ≥ 40 dB."""
    cfg = _cfg("proposal.enabled=false", f"kernels.carry_hoist={hoist}")
    out_j, out_t = _both(scene, cfg, with_proposal=False)
    assert out_t["fine"]["weights"].shape == (256, 128)
    for key in ("coarse", "fine"):
        p = _psnr(out_t, out_j, key)
        assert p >= 40.0, (key, p)


def test_render_image_carry_hoist_false_matches_reference(scene):
    """The slice as a whole: the 40×40 frame in 256-ray chunks (8×8
    pixel-block order, pad rays, dead-chunk skip) with the fine march
    through K6's plain version, ≥ 40 dB against the reference's frame."""
    params_j, occ_j, params_t, occ_t = scene
    cfg = _cfg("render.chunk=256", "kernels.carry_hoist=false")
    img_j = jbw.render_image_blockwise(params_j, cfg, IMG, IMG, FOCAL,
                                       _c2w(), occ=occ_j)
    img_j = {k: np.asarray(v) for k, v in jax.device_get(img_j).items()}
    with torch.no_grad():
        img_t = tbw.render_image_blockwise(params_t, cfg, IMG, IMG, FOCAL,
                                           _c2w(), occ=occ_t)
    assert img_t["rgb"].shape == (IMG, IMG, 3)
    p = float(psnr(img_t["rgb"], torch.tensor(img_j["rgb"])))
    assert p >= 40.0, p
    np.testing.assert_allclose(img_t["acc"].numpy(), img_j["acc"], atol=2e-2)
    live = img_t["chunk_live"].numpy()
    assert live.any() and not live.all()


def test_pack_render_params_follows_the_config(scene):
    """K2 packs the x-layers hoisted, K6 keeps the x rows in the operand;
    without a proposal the coarse net is packed in its place."""
    _, _, params_t, _ = scene
    p = tbw.pack_render_params(params_t, _cfg())
    assert set(p) == {"fine", "proposal"} and not p["fine"].x_rows
    p = tbw.pack_render_params(params_t, _cfg("kernels.carry_hoist=false",
                                              "proposal.enabled=false"))
    assert set(p) == {"fine", "coarse"}
    assert p["fine"].x_rows and p["coarse"].x_rows
