"""mip-NeRF 360 through the port (`mipnerf360` preset): the cone Gaussians,
the contraction and the IPE against closed forms; the chunk function
against the benchmark's plain reference (perfbench/reference/mipnerf360.py,
the one reference the benchmark's comparison uses); K7's plain version and
packing; the hand counts; the ranges. Tests marked `cuda` put K7 against
its plain version on the card and skip without one:
    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_mipnerf360.py
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fashion_nerf_torch.config import load_config  # noqa: E402
from fashion_nerf_torch.core import cones  # noqa: E402
from fashion_nerf_torch.core.sampling import resample_intervals  # noqa: E402
from fashion_nerf_torch.kernels import wgpack, widefield  # noqa: E402
from fashion_nerf_torch.models.mipnerf360 import (from_tree,  # noqa: E402
                                                  init_nets, nets_of)
from fashion_nerf_torch.render.blockwise import (  # noqa: E402
    render_image_blockwise)
from perfbench import roofline  # noqa: E402
from perfbench.reference import mipnerf360 as ref  # noqa: E402

SMALL = ["model.net_depth=4", "model.net_width=32", "model.skips=1",
         "model.bottleneck_width=32", "model.view_width=16",
         "proposal.net_depth=2", "proposal.net_width=16"]


def _c2w(radius=0.9, theta=0.7, phi=-0.26):
    """A camera on a sphere looking at the origin (z up)."""
    pos = radius * np.array([math.cos(phi) * math.sin(theta),
                             -math.cos(phi) * math.cos(theta),
                             -math.sin(phi)])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


# --- the Gaussians, the contraction, the encoding ----------------------------

@pytest.mark.parametrize("t0,t1,rad", [(0.2, 0.23, 0.004), (1.5, 3.0, 0.01),
                                       (40.0, 900.0, 0.002)])
def test_frustum_moments_match_the_integrals(t0, t1, rad):
    """mip-NeRF's eq. 7: the moments of the cone's volume over [t0, t1]
    (density ∝ t²), E t = ¾ (t1⁴ − t0⁴)/(t1³ − t0³), E t² = ⅗ (t1⁵ − t0⁵)/
    (t1³ − t0³), σ_r² = ṙ² · ³⁄₂₀ (t1⁵ − t0⁵)/(t1³ − t0³)."""
    t0_, t1_ = torch.tensor(t0, dtype=torch.float64), torch.tensor(
        t1, dtype=torch.float64)
    m, v, r = cones.frustum_moments(t0_, t1_, rad)
    d3, d4, d5 = t1 ** 3 - t0 ** 3, t1 ** 4 - t0 ** 4, t1 ** 5 - t0 ** 5
    mean = 0.75 * d4 / d3
    assert float(m) == pytest.approx(mean, rel=1e-12)
    assert float(v) == pytest.approx(0.6 * d5 / d3 - mean ** 2, rel=1e-6)
    assert float(r) == pytest.approx(rad ** 2 * 0.15 * d5 / d3, rel=1e-12)


def test_contract_inside_and_outside_the_ball():
    x = torch.tensor([[0.3, -0.4, 0.5], [0.0, 0.0, 2.0], [3.0, 4.0, 0.0],
                      [1e5, 0.0, 0.0]], dtype=torch.float64)
    y = cones.contract(x)
    assert torch.equal(y[0], x[0])
    assert torch.allclose(y[1], torch.tensor([0.0, 0.0, 1.5],
                                             dtype=torch.float64))
    assert torch.allclose(y[2], torch.tensor([3.0, 4.0, 0.0],
                                             dtype=torch.float64) * 1.8 / 5)
    assert float(torch.linalg.norm(y[3])) == pytest.approx(2.0 - 1e-5)


@pytest.mark.parametrize("x", [[0.2, 0.1, -0.3], [1.4, -0.2, 0.9],
                               [-6.0, 2.0, 11.0]])
def test_jacobian_matches_finite_differences(x):
    x = torch.tensor(x, dtype=torch.float64)
    J = cones.contract_jacobian(x)
    h = 1e-6
    fd = torch.stack([(cones.contract(x + h * e) - cones.contract(x - h * e))
                      / (2 * h) for e in torch.eye(3, dtype=torch.float64)],
                     dim=1)
    assert torch.allclose(J, fd, atol=1e-8)


def test_contracted_diagonal_is_j_sigma_jt():
    """The closed form of diag(J Σ Jᵀ) against the 3 × 3 product, for
    intervals inside and outside the unit ball."""
    g = torch.Generator().manual_seed(0)
    o = torch.randn((6, 3), generator=g, dtype=torch.float64) * 0.5
    d = torch.randn((6, 3), generator=g, dtype=torch.float64)
    tdist = torch.tensor([0.2, 0.5, 1.0, 2.5, 8.0, 100.0],
                         dtype=torch.float64).expand(6, 6)
    mean, var = cones.cone_gaussians(o, d, 0.003, tdist)
    tm, tv, rv = cones.frustum_moments(tdist[:, :-1], tdist[:, 1:], 0.003)
    mu = o[:, None] + d[:, None] * tm[..., None]
    dd = (d * d).sum(-1)
    outer = d[:, :, None] * d[:, None, :]
    cov = (tv[..., None, None] * outer[:, None] + rv[..., None, None]
           * (torch.eye(3, dtype=torch.float64) - outer / dd[:, None, None]
              )[:, None])
    J = cones.contract_jacobian(mu)
    want = torch.diagonal(J @ cov @ J.transpose(-1, -2), dim1=-2, dim2=-1)
    assert torch.allclose(var, want, rtol=1e-9, atol=1e-15)
    assert torch.allclose(mean, cones.contract(mu))
    assert bool((torch.linalg.norm(mu, dim=-1) > 1).any())
    assert bool((torch.linalg.norm(mu, dim=-1) <= 1).any())


def test_ipe_is_the_expected_sine_and_cosine():
    """E sin(2ˡX), E cos(2ˡX) of X ~ N(μ, σ²) by Gauss-Hermite quadrature,
    feature for feature, and plain sin/cos at σ = 0."""
    mu = torch.tensor([[0.3, -1.1, 1.7]], dtype=torch.float64)
    var = torch.tensor([[0.01, 0.0004, 0.002]], dtype=torch.float64)
    L = 4
    got = cones.ipe(mu, var, L)[0]
    x, w = np.polynomial.hermite.hermgauss(80)
    want = []
    for f in (np.sin, np.cos):
        for l in range(L):
            for a in range(3):
                s = mu[0, a].item() + math.sqrt(2 * var[0, a].item()) * x
                want.append(float((w * f(2 ** l * s)).sum() / math.sqrt(
                    math.pi)))
    assert torch.allclose(got, torch.tensor(want, dtype=torch.float64),
                          atol=1e-10)
    plain = cones.ipe(mu, torch.zeros_like(var), L)[0]
    ph = (mu[0][None, :] * 2.0 ** torch.arange(L)[:, None]).reshape(-1)
    assert torch.allclose(plain, torch.cat([ph.sin(), ph.cos()]), atol=1e-12)


def test_resample_puts_the_centres_at_the_quantiles():
    """All the mass in one interval: the centres evenly inside it, the
    edges between them, the ends reflected; the reference's resampling
    gives the same edges."""
    edges = torch.linspace(0.0, 1.0, 5).expand(2, 5)
    w = torch.tensor([[0.0, 1.0, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25]])
    got = resample_intervals(edges, w, 4, eps=0.0)
    assert torch.allclose(got[0], torch.linspace(0.25, 0.5, 5), atol=1e-6)
    assert torch.allclose(got[1], torch.linspace(0.0, 1.0, 5), atol=1e-6)
    w2 = torch.rand((3, 64), generator=torch.Generator().manual_seed(1))
    e2 = torch.linspace(0.0, 1.0, 65).expand(3, 65)
    assert torch.allclose(resample_intervals(e2, w2, 32),
                          ref.resample(e2, w2, 32), atol=1e-6)


# --- the nets, the preset, the counts ----------------------------------------

def test_preset_has_the_published_widths():
    cfg = load_config("mipnerf360")
    m, p, s = cfg.model, cfg.proposal, cfg.sampling
    assert (m.net_depth, m.net_width, m.skips) == (8, 1024, (4,))
    assert (m.bottleneck_width, m.view_width, m.ipe_deg) == (256, 128, 12)
    assert (p.net_depth, p.net_width, p.eval_n, s.n_fine) == (4, 256, 64, 32)
    assert s.lindisp and (cfg.render.near, cfg.render.far) == (0.2, 1e6)


@pytest.mark.parametrize("net,macs", [("fine", 7_787_264),
                                      ("proposal", 215_296)])
def test_hand_counts_through_eval_macs(net, macs):
    """The hand count: the NeRF MLP 72×1024 + 4×1024² + 1096×1024
    + 2×1024² + 1024 + 1024×256 + 283×128 + 128×3, the proposal 72×256 +
    3×256² + 256, on the preset's trees and on the benchmark's."""
    from perfbench.drivers.render_m360 import net_shapes
    cfg = load_config("mipnerf360")
    tree = _published()[net].to_tree()
    assert roofline.eval_macs(tree) == macs
    from fashion_nerf_torch.config import config_to_dict
    shapes = net_shapes(config_to_dict(cfg))[net]
    assert [(n, r, c) for n, r, c in shapes] == [
        (n, *v["kernel"].shape) for n, v in tree["params"].items()]


def _published(seed=0):
    cfg = load_config("mipnerf360")
    return init_nets(cfg, torch.Generator().manual_seed(seed))


def test_k7_plain_version_against_the_reference_nets():
    """K7's plain version (bf16 operands, f32 sums) against the reference's
    float32 nets at the published widths on 256 rows: σ and rgb to the
    bf16 rounding of the operands (measured ~1e-2 of σ's spread)."""
    nets = _published()
    g = torch.Generator().manual_seed(4)
    mean = (torch.rand((256, 3), generator=g) * 4 - 2)
    var = torch.rand((256, 3), generator=g) * 1e-3
    dirs = torch.randn((8, 3), generator=g)
    for name, net in nets.items():
        packed = widefield.pack_wide(net)
        dp = (widefield.dir_term(packed, dirs) if packed.has_vd else None)
        rgb, sigma = widefield.wide_rows_plain(packed, mean, var, dp, 32)
        mlp = ref.MLP(net.to_tree(), "cpu")
        enc = (ref.dir_encoding(dirs, 4).repeat_interleave(32, 0)
               if packed.has_vd else None)
        rgb_r, sigma_r = mlp(ref.ipe(mean, var, 12), enc)
        spread = float(sigma_r.std())
        assert float((sigma - sigma_r).abs().max()) < 0.05 * spread, name
        if packed.has_vd:
            assert float((rgb - rgb_r).abs().max()) < 0.01
        f32 = widefield.pack_wide(net, bf16=False)
        _, sigma32 = widefield.wide_rows_plain(f32, mean, var, dp, 32)
        assert torch.allclose(sigma32, sigma_r, atol=1e-4 * spread), name


def test_k7_buffers_hold_the_weights():
    """The kernel's slices, unpacked from wgpack's core-matrix order, are
    the bf16 weights in the layout `wide_layout` gives."""
    nets = _published()
    for name, net in nets.items():
        p = widefield.pack_wide(net)
        W, lay = p.width, widefield.wide_layout(p.depth, p.width, p.skips,
                                                p.has_vd)
        for i in range(p.depth):
            off, kb_h, kb_a = lay["layers"][i]
            rows = ([p.w_h[i]] if kb_h else []) + (
                [torch.cat([p.w_a[i], torch.zeros(128 - 72, W)])]
                if kb_a else [])
            full = torch.cat(rows)
            for nt in range(W // 256):
                for kb in range(kb_h + kb_a):
                    got = wgpack._untile(p.wp[off:off + 64 * 256].float(),
                                         64, 256)
                    assert torch.equal(got, full[kb * 64:(kb + 1) * 64,
                                                 nt * 256:(nt + 1) * 256])
                    off += 64 * 256
        assert torch.equal(p.b[lay["b_sig"]], net.sigma_head.bias[0])
        if p.has_vd:
            view = wgpack._untile(p.wp[lay["view"]:lay["view"] + 64 * 128]
                                  .float(), 64, 128)
            assert torch.equal(view, p.heads["vb"][:64])
            assert lay["n_wp"] == lay["view"] + 256 * 128


def test_k7_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        widefield.check_wide_shape(512, 8, (4,), 12)
    with pytest.raises(ValueError):
        widefield.check_wide_shape(1024, 8, (1, 4), 12)
    with pytest.raises(ValueError):
        widefield.check_wide_shape(1024, 8, (4,), 22)
    widefield.check_wide_shape(1024, 8, (4,), 12, 256, 128)
    widefield.check_wide_shape(256, 4, (), 12)


# --- the chunk function against the reference --------------------------------

def _small_frame(dtype):
    cfg = load_config("mipnerf360", SMALL + [f"model.compute_dtype={dtype}"])
    nets = init_nets(cfg, torch.Generator().manual_seed(7))
    trees = {k: v.to_tree() for k, v in nets.items()}
    return cfg, nets, trees


@pytest.mark.parametrize("pose", [0, 1])
def test_chunk_function_matches_the_reference_in_f32(pose):
    """A 16×12 frame of 4×32 and 2×16 nets, the 64/64/32 samples kept,
    through `render_image_blockwise` (float32: K7's plain version without
    rounding) against the reference, to float32 rounding. Both sides sum
    in other orders; a rounding of s moves t by 5t²·δs near the far end
    (g = 1/x), a phase of up to 2¹¹ rad turns an ulp of the mean into
    2e-4 rad, and two resamplings carry both on: measured mean 1.4e-5-1.7e-5
    and max 1.9e-4-2.5e-4 over the rgb, max 4.7e-4 over acc, on three
    poses. A wrong Gaussian, contraction or resampling moves them by 1e-2."""
    from fashion_nerf_torch.config import config_to_dict
    cfg, nets, trees = _small_frame("float32")
    c2w = _c2w() if pose == 0 else _c2w(3.0, 2.0, 0.4)
    with torch.no_grad():
        got = render_image_blockwise(nets, cfg, 12, 16, 14.0, c2w,
                                     device="cpu")
    want = ref.render_frame(config_to_dict(cfg), ref.build(trees, "cpu"),
                            12, 16, 14.0, c2w, "cpu")
    assert got["rgb"].shape == want["rgb"].shape == (12, 16, 3)
    err = (got["rgb"] - want["rgb"]).abs()
    assert float(err.mean()) < 5e-5 and float(err.max()) < 1e-3
    assert float((got["acc"] - want["acc"]).abs().max()) < 2e-3


@pytest.mark.parametrize("fault", ["resample_low", "uncontracted"])
def test_planted_faults_leave_float32_rounding(fault):
    """The benchmark driver's faults in the layers only mip-NeRF 360 runs
    (the resampling at the quantiles k/n, the variances left uncontracted)
    move the same frame's mean error past ten times the rounding the test
    above allows (read on the CPU: 7.1e-3 and 2.0e-3)."""
    from fashion_nerf_torch.config import config_to_dict
    from perfbench.drivers.render_m360 import FAULTS
    cfg, nets, trees = _small_frame("float32")
    with torch.no_grad(), FAULTS[fault]():
        got = render_image_blockwise(nets, cfg, 12, 16, 14.0, _c2w(),
                                     device="cpu")
    want = ref.render_frame(config_to_dict(cfg), ref.build(trees, "cpu"),
                            12, 16, 14.0, _c2w(), "cpu")
    err = (got["rgb"] - want["rgb"]).abs()
    assert float(err.mean()) > 5e-4, float(err.mean())


def test_bf16_frame_is_near_the_reference():
    """The preset's bf16 numerics: the same frame within the rounding of
    bf16 operands."""
    from fashion_nerf_torch.config import config_to_dict
    cfg, nets, trees = _small_frame("bfloat16")
    with torch.no_grad():
        got = render_image_blockwise(nets, cfg, 12, 16, 14.0, _c2w(),
                                     device="cpu")
    want = ref.render_frame(config_to_dict(cfg), ref.build(trees, "cpu"),
                            12, 16, 14.0, _c2w(), "cpu")
    err = (got["rgb"] - want["rgb"]).abs()
    assert 0 < float(err.mean()) < 2e-3 and float(err.max()) < 2e-2


def test_the_ranges_open_in_a_cpu_render():
    from torch.profiler import ProfilerActivity, profile
    cfg, nets, _ = _small_frame("float32")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        render_image_blockwise(nets, cfg, 12, 16, 14.0, _c2w(), device="cpu")
    names = {e.name for e in prof.events()}
    for rng in ("fnt.chunk.march", "fnt.rays.cones", "fnt.rays.prop",
                "fnt.rays.resample", "fnt.rays.nerf"):
        assert rng in names, rng
    counts = {n: sum(e.name == n for e in prof.events())
              for n in ("fnt.rays.prop", "fnt.rays.resample", "fnt.rays.nerf",
                        "fnt.rays.cones", "fnt.chunk.march")}
    chunks = counts["fnt.chunk.march"]
    assert counts["fnt.rays.prop"] == counts["fnt.rays.resample"] == \
        2 * chunks
    assert counts["fnt.rays.cones"] == 3 * chunks == 3 * counts[
        "fnt.rays.nerf"]


def test_from_tree_round_trips():
    nets = _published(3)
    kw = nets_of(load_config("mipnerf360"))
    for name, net in nets.items():
        back = from_tree(net.to_tree(), **kw[name])
        for a, b in zip(net.parameters(), back.parameters()):
            assert torch.equal(a, b)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("net,rows", [("proposal", 8192), ("fine", 4096)])
def test_k7_against_its_plain_version_on_the_card(dev, net, rows):
    """K7 at both widths against its plain version on the card: the same
    bf16 operands and f32 sums in another order (σ to 1e-3 of its spread,
    rgb to 1e-3)."""
    from fashion_nerf_torch import kernels as K
    m = _published(5)[net].to(dev)
    p = widefield.pack_wide(m)
    g = torch.Generator(device=dev).manual_seed(6)
    spr = 64 if net == "proposal" else 32
    mean = torch.rand((rows, 3), generator=g, device=dev) * 4 - 2
    var = torch.rand((rows, 3), generator=g, device=dev) * 1e-3
    dirs = torch.randn((rows // spr, 3), generator=g, device=dev)
    dp = widefield.dir_term(p, dirs).contiguous() if p.has_vd else None
    before = K.LAUNCHES["wide_field"]
    with torch.no_grad():
        rgb, sigma = widefield.wide_rows(p, mean, var, dp, spr)
        rgb_p, sigma_p = widefield.wide_rows_plain(p, mean, var, dp, spr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["wide_field"] == before + 1
    spread = float(sigma_p.std())
    assert float((sigma - sigma_p).abs().max()) < 1e-3 * max(spread, 1.0)
    if p.has_vd:
        assert float((rgb - rgb_p).abs().max()) < 1e-3


@pytest.mark.cuda
def test_full_width_frame_against_the_reference_on_the_card(dev):
    """A 96×64 frame at the published widths through the kernels against
    the reference: within the limits of the benchmark's cell."""
    import json
    from fashion_nerf_torch.config import config_to_dict
    cfg = load_config("mipnerf360")
    nets = {k: v.to(dev) for k, v in _published(8).items()}
    trees = {k: v.to_tree() for k, v in nets.items()}
    with torch.no_grad():
        got = render_image_blockwise(nets, cfg, 64, 96, 60.0, _c2w(),
                                     device=dev)
    want = ref.render_frame(config_to_dict(cfg), ref.build(trees, dev), 64,
                            96, 60.0, _c2w(), dev)
    err = (got["rgb"] - want["rgb"]).abs().reshape(-1).cpu()
    with open(os.path.join(ROOT, "perfbench", "checks",
                           "m360.render.orbit.json")) as f:
        limits = json.load(f)["limits"]
    assert float(err.mean()) <= limits["rgb_mae"]
    assert float(torch.quantile(err, 0.99)) <= limits["rgb_p99"]
