"""The port's blockwise slice (fashion_nerf_torch.render.blockwise) against
the JAX reference, end to end on the flagship weights and the committed
proposal asset. The reference runs its Pallas marches in interpret mode on
the CPU; the port runs the kernels' plain versions. Both sides take the
same occupancy state (the reference's, converted to tensors), so they make
the same culling decisions."""

import functools

import jax
import jax.numpy as jnp
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
from fashion_nerf_torch.core.occupancy import OccupancyState, block_overlap
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.render import blockwise as tbw
from gathered_frame import gathered_frame

torch.set_num_threads(2)

H = W = 32
FOCAL = 0.5 * W / np.tan(0.5 * 0.6911)      # the bench framing at 32×32
# the image test: a 40×40 frame at the same focal (a wider view) is 1600
# rays = six 256-ray chunks and one padded with 192 pad rays; at the bench
# pose its first and last two chunks miss the occupancy box
IMG = 40


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
    assert "proposal" in params_j
    fine = load_flax_params(params["fine"], compute_dtype="bfloat16")
    params_t = attach_proposal(cfg, {"fine": fine})
    occ_t = OccupancyState(*[torch.tensor(np.asarray(x)) for x in occ_j])
    return params_j, occ_j, params_t, occ_t


def test_render_rays_blockwise_matches_reference(scene):
    """256 rays across the object (rows 12-19 of the 32×32 frame): fine rgb
    ≥ 40 dB, proposal acc atol 5e-3 (tests/kernels/test_sigmamarch.py:
    131-135)."""
    params_j, occ_j, params_t, occ_t = scene
    cfg = _cfg()
    ro, rd = j_rays(H, W, FOCAL, _c2w())
    ro = np.asarray(ro).reshape(-1, 3)[384:640]
    rd = np.asarray(rd).reshape(-1, 3)[384:640]
    out_j = jbw.render_rays_blockwise(params_j, cfg, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(rd),
                                      occ=occ_j)
    with torch.no_grad():
        out_t = tbw.render_rays_blockwise(
            params_t, cfg, torch.tensor(ro), torch.tensor(rd),
            torch.tensor(rd), occ=occ_t)
    rgb_j = torch.tensor(np.asarray(out_j["fine"]["rgb"]))
    p = float(psnr(out_t["fine"]["rgb"], rgb_j))
    assert p >= 40.0, p
    np.testing.assert_allclose(out_t["coarse"]["acc"].numpy(),
                               np.asarray(out_j["coarse"]["acc"]), atol=5e-3)
    acc = out_t["fine"]["acc"].numpy()
    assert acc.max() > 0.9 and acc.min() == 0.0    # surface and misses


@pytest.fixture(scope="module")
def images(scene):
    params_j, occ_j, params_t, occ_t = scene
    cfg = _cfg("render.chunk=256")
    img_j = jbw.render_image_blockwise(params_j, cfg, IMG, IMG, FOCAL,
                                       _c2w(), occ=occ_j)
    img_j = {k: np.asarray(v) for k, v in jax.device_get(img_j).items()}
    with torch.no_grad():
        img_t = tbw.render_image_blockwise(params_t, cfg, IMG, IMG, FOCAL,
                                           _c2w(), occ=occ_t)
    return img_j, {k: v.numpy() for k, v in img_t.items()}


def test_render_image_blockwise_matches_reference(images):
    """40×40 frame in 256-ray chunks (8×8 pixel-block order, pad rays,
    dead-chunk skip): ≥ 40 dB against the reference."""
    img_j, img_t = images
    assert img_t["rgb"].shape == (IMG, IMG, 3)
    p = float(psnr(torch.tensor(img_t["rgb"]), torch.tensor(img_j["rgb"])))
    assert p >= 40.0, p
    np.testing.assert_allclose(img_t["acc"], img_j["acc"], atol=2e-2)


def test_dead_chunks_are_exact_background(images):
    img_j, img_t = images
    live = img_t["chunk_live"]
    assert live.any() and not live.all()
    # the bottom-right 8×8 block shares the last chunk with the pad rays
    assert not live[-8:, -8:].any()
    np.testing.assert_array_equal(img_t["rgb"][~live], 1.0)
    np.testing.assert_array_equal(img_j["rgb"][~live], 1.0)
    np.testing.assert_array_equal(img_t["acc"][~live], 0.0)


def test_tile_order_matches_reference():
    for h, w in ((32, 32), (16, 40)):
        for a, b in zip(tbw._tile_order(h, w), jbw._tile_order(h, w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h, w", [(32, 32), (16, 40), (800, 800)])
def test_tile_permutation_is_tile_order(h, w):
    """The views' permutation on the pixel indices is `_tile_order`'s
    order, its undo is the inverse, and the round trip is the identity
    for trailing shapes () and (3,)."""
    order, inv = tbw._tile_order(h, w)
    idx = torch.arange(h * w)
    np.testing.assert_array_equal(tbw._to_tiles(idx, h, w).numpy(), order)
    back = tbw._from_tiles(idx, h, w)
    assert back.shape == (h, w)
    np.testing.assert_array_equal(back.reshape(-1).numpy(), inv)
    for x in (torch.randn(h * w), torch.randn(h * w, 3)):
        back = tbw._from_tiles(tbw._to_tiles(x, h, w), h, w)
        assert torch.equal(back, x.reshape((h, w) + x.shape[1:]))


@pytest.mark.parametrize("h, w, all_live", [(32, 32, False),
                                            (24, 20, True)])
def test_frame_is_the_gathered_frame(scene, h, w, all_live):
    """A frame in 256-ray chunks at half the bench focal, tiled (32×32:
    two of its four chunks miss the box) and in scanline order (24×20, 480
    rays: one chunk padded), is bit for bit the frame built by index
    gathers (tests/gathered_frame.py)."""
    _, _, params_t, occ_t = scene
    cfg = _cfg("render.chunk=256")
    focal = FOCAL / 2
    with torch.no_grad():
        got = tbw.render_image_blockwise(params_t, cfg, h, w, focal, _c2w(),
                                         occ=occ_t)
        want = gathered_frame(params_t, cfg, h, w, focal, _c2w(), occ=occ_t)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape[:2] == (h, w), k
        assert torch.equal(got[k], want[k]), k
    live = got["chunk_live"]
    assert live.any() and bool(live.all()) == all_live


def _axis_rays(n=64):
    ro = torch.zeros((n, 3))
    ro[:, 2] = 4.0
    rd = torch.zeros((n, 3))
    rd[:, 2] = -1.0
    return ro, rd


@pytest.mark.parametrize("ovr", [
    "proposal.sigma_march=false", "kernels.fused_carry=false",
    "proposal.eval_n=96", "render.ndc=true", "occupancy.sample_warp=true",
    "proposal.union=true", "proposal.cov_n=16"])
def test_ported_branches_run(scene, ovr):
    """The branches ported since (the generic proposal march, the
    two-stage march, NDC, the occupancy-warped samples and width caps, the
    union and the coverage samples of the fine march) render 64 rays down
    the axis through the object with the trained nets: finite outputs, an
    opaque centre. Their parity with the reference is in
    tests/test_torch_blockwise_twostage.py and
    tests/test_torch_branches.py."""
    _, _, params_t, occ_t = scene
    ro, rd = _axis_rays()
    with torch.no_grad():
        out = tbw.render_rays_blockwise(params_t, _cfg(ovr), ro, rd, rd,
                                        occ=occ_t)
    assert torch.isfinite(out["fine"]["rgb"]).all()
    assert float(out["fine"]["acc"].min()) > 0.9


@pytest.mark.parametrize("t_end", [None, 6.0])
def test_march_helpers_match_reference(t_end):
    """_pass_dists (∞ or t_end on the last interval, zero-width pads),
    _block_hit_flags' composition on materialised segments
    (`block_overlap`: a block ends at the max over the block, so pad
    sentinels never end one) and _pdf_bins (edge and mid bins), on 80
    samples padded to 96 at SB=32: f32 rtol 1e-6, flags exact."""
    rng = np.random.default_rng(7)
    R, S, SB, K = 64, 80, 32, 5
    t = np.sort(rng.uniform(2.0, 5.5, (R, S)), 1).astype(np.float32)
    dn = rng.uniform(0.9, 1.3, (R, 1)).astype(np.float32)
    tp_j, dp_j = jbw._pass_dists(jnp.asarray(t), jnp.asarray(dn), t_end, SB)
    tp_t, dp_t = tbw._pass_dists(torch.tensor(t), torch.tensor(dn), t_end,
                                 SB)
    np.testing.assert_array_equal(tp_t.numpy(), np.asarray(tp_j))
    np.testing.assert_allclose(dp_t.numpy(), np.asarray(dp_j), rtol=1e-6)
    lo = rng.uniform(2.0, 6.0, (R, K)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 1.0, (R, K)).astype(np.float32)
    hit = rng.uniform(size=(R, K)) < 0.5
    bh_j = jbw._block_hit_flags(tp_j, SB, tuple(map(jnp.asarray,
                                                    (lo, hi, hit))), R, 3)
    bh_t = block_overlap(tp_t, SB, tuple(map(torch.tensor, (lo, hi, hit))),
                         R, 3)
    np.testing.assert_array_equal(bh_t.numpy(), np.asarray(bh_j))
    assert 0 < bh_t.sum() < bh_t.numel()
    w = rng.uniform(size=(R, S)).astype(np.float32)
    for edge in (True, False):
        for a, b in zip(tbw._pdf_bins(torch.tensor(t), torch.tensor(w), edge),
                        jbw._pdf_bins(jnp.asarray(t), jnp.asarray(w), edge)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
