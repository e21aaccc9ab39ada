"""K8's plain versions (fashion_nerf_torch.kernels.boxcull) against the
torch composition they replace on the render path: `box_cull` on the
occupied boxes equal to `ray_multi_aabb`'s union interval and hit over
all K boxes with their flags, `block_hit` equal to the block flags of its
materialised segments, on the CPU (tests/test_torch_cuda.py holds the
kernel to them on the card). And `culling`: a `BoxSegments` handle of the
occupied boxes, with or without `occupancy.sample_warp`."""

import contextlib

import numpy as np
import pytest
import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.core import occupancy as tocc
from fashion_nerf_torch.kernels import boxcull
from fashion_nerf_torch.render import blockwise as tbw

NEAR, FAR = 2.0, 6.0


def _occ(empty=False):
    """Two σ blobs on a 32³ lattice, reduced to 8³ = 512 macro boxes."""
    def field(p, dirs):
        a = ((p - torch.tensor([0.5, 0.2, -0.3])) ** 2).sum(-1).sqrt() < 0.45
        b = ((p - torch.tensor([-0.9, -0.6, 0.8])) ** 2).sum(-1).sqrt() < 0.3
        return None, torch.where(a | b, 5.0, -1.0)
    occ = tocc.build_occupancy(field, -2.0, 2.0, resolution=32,
                               sigma_threshold=0.1, margin_cells=1, macro=8,
                               chunk=4096)
    if empty:
        occ = occ._replace(boxes_occ=torch.zeros_like(occ.boxes_occ))
    return occ


def _rays(case, occ, R=256, seed=0):
    """(R,3) origins and directions of one case: camera rays from radius 4
    at the scene, some axis-parallel (their reciprocals at ±1e10), rays
    from inside an occupied box, rays that miss every box."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.normal(0, 0.6, (R, 3))
    if case == "axis":
        d[: R // 2, 0] = 0.0
        d[R // 4: R // 2, 1] = -0.0
        d[R // 2: 3 * R // 4, 1:] = 0.0
        o[R // 2: 3 * R // 4, 1:] = rng.uniform(-0.5, 0.5, (R // 4, 2))
    elif case == "inside":
        centers = 0.5 * (occ.boxes_min + occ.boxes_max)[occ.boxes_occ]
        o = centers.numpy()[rng.integers(0, len(centers), R)]
        d = rng.normal(size=(R, 3))
    elif case == "miss":
        d = o + rng.normal(0, 0.1, (R, 3))     # away from the scene
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("NB,SB,S", [(1, 64, 56), (3, 32, 80)])
@pytest.mark.parametrize("case", ["generic", "axis", "inside", "miss",
                                  "empty"])
def test_plain_twins_equal_the_composition(case, NB, SB, S):
    """box_cull and block_hit (the CPU path: their plain versions) on the
    occupied boxes alone (`occupied_boxes`; with none occupied, its one
    box of zero volume), and the blockwise render's block flags of the
    handle, each equal to the composition over all 512 boxes with their
    flags; t_pad is S stratified samples between the ray's near and far,
    zero-padded to NB·SB. Rays from inside a box start at near 0."""
    occ = _occ(empty=case == "empty")
    o, d = _rays(case, occ)
    R = o.shape[0]
    near_t = 0.0 if case == "inside" else NEAR   # start inside the box
    want = tocc.ray_multi_aabb(o, d, occ, near_t, FAR)
    lo, hi = tocc.occupied_boxes(occ)
    n = int(occ.boxes_occ.sum())
    assert lo.shape == hi.shape == (max(n, 1), 3)
    assert torch.equal(lo, occ.boxes_min[occ.boxes_occ]) or n == 0
    seg = tocc.box_segments(o, d, lo, hi, near_t, FAR)
    got = boxcull.box_cull(seg)
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b)
    near, far, hit = want[:3]
    t = tbw.stratified_sample(near, far, R, S)
    t_pad, _ = tbw._pass_dists(t, torch.ones((R, 1)), FAR, SB)
    assert t_pad.shape == (R, NB * SB) and bool((t_pad[:, S:] == 0).all())
    flags = tocc.block_overlap(t_pad, SB, want[3:], R, NB)
    assert torch.equal(boxcull.block_hit(t_pad, SB, seg), flags)
    for plain in (False, True):
        with K.plain_versions() if plain else contextlib.nullcontext():
            assert torch.equal(tbw._block_hit_flags(t_pad, SB, seg), flags)
    if case == "axis":
        assert bool((seg.inv_d[: 3 * R // 4].abs() > 9e9).any(dim=1).all())
    n_hit = int(hit.sum())
    if case in ("miss", "empty"):
        assert n_hit == 0 and not flags.any()
        assert bool((near == FAR).all() and (far == FAR).all())
    elif case == "inside":
        assert n_hit == R and flags.any()
    else:
        assert 0 < n_hit and 0 < flags.sum() < flags.numel()


@pytest.mark.parametrize("warp", [False, True])
def test_culling_segments(warp):
    """`culling` gives a `BoxSegments` handle of the chunk's rays against
    the occupied boxes, with or without `occupancy.sample_warp` (whose
    bins materialise the handle's segments), the union interval and hit of
    `ray_multi_aabb`, and the same whether it compacts the boxes itself or
    is handed them."""
    cfg = load_config("blender_lego", [f"occupancy.sample_warp={warp}"])
    occ = _occ()
    o, d = _rays("generic", occ, R=128, seed=3)
    lo, hi = tocc.occupied_boxes(occ)
    want = tocc.ray_multi_aabb(o, d, occ, cfg.render.near, cfg.render.far)
    for boxes in (None, (lo, hi)):
        near, far, alive0, seg, t_end = tbw.culling(cfg, o, d, occ, boxes)
        for a, b in zip((near, far, alive0), want[:3]):
            assert torch.equal(a, b)
        assert t_end == cfg.render.far
        assert isinstance(seg, tocc.BoxSegments)
        assert torch.equal(seg.rays_o, o)
        assert torch.equal(seg.inv_d, tocc._safe_inv(d))
        assert torch.equal(seg.lo, lo) and torch.equal(seg.hi, hi)
        assert (seg.near, seg.far) == (cfg.render.near, cfg.render.far)
        s_lo, s_hi, s_hit = boxcull.segments_plain(seg)[3:]
        assert s_lo.shape == (128, lo.shape[0]) and lo.shape[0] < 512
        m = occ.boxes_occ
        assert torch.equal(s_hit, want[5][:, m])
        assert torch.equal(s_lo, want[3][:, m])
    assert 0 < int(alive0.sum()) < 128


def test_packing_compacts_the_boxes_once_an_image():
    """`pack_render_params` holds the occupied boxes for the image's
    chunks when the config culls against macro boxes, and none without an
    occupancy state or with the global box alone (macro 1)."""
    from fashion_nerf_torch.models.nerf_mlp import init_field
    cfg = load_config("blender_lego", ["proposal.enabled=false"])
    net = init_field(cfg.model, torch.Generator().manual_seed(0))
    params = {"fine": net, "coarse": net}
    occ = _occ()
    p = tbw.pack_render_params(params, cfg, occ)
    assert set(p) == {"fine", "coarse", "boxes"}
    for a, b in zip(p["boxes"], (occ.boxes_min, occ.boxes_max)):
        assert torch.equal(a, b[occ.boxes_occ]) and a.is_contiguous()
    assert "boxes" not in tbw.pack_render_params(params, cfg)
    cfg1 = load_config("blender_lego", ["proposal.enabled=false",
                                        "occupancy.macro=1"])
    assert "boxes" not in tbw.pack_render_params(params, cfg1, occ)
