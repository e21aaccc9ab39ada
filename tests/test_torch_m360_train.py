"""mip-NeRF 360 training through the port (`mipnerf360` preset,
train/m360.py): the step against the benchmark's plain reference
(perfbench/reference/train_m360.py), the losses against brute-force forms,
the stop-gradients, K7's plain backward against autograd of its plain
forward, the learning rate and the clipping against closed forms, and
`train()` and the command line's `train`, `eval` and `render` on a tiny
LLFF scene. Tests marked `cuda` put K7's backward against its plain
version on the card and skip without one:
    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_m360_train.py
"""

import contextlib
import json
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

from fashion_nerf_torch.config import (config_to_dict,  # noqa: E402
                                       load_config)
from fashion_nerf_torch.data.pipeline import RayDataset  # noqa: E402
from fashion_nerf_torch.kernels import widefield  # noqa: E402
from fashion_nerf_torch.models.mipnerf360 import (MipMLP,  # noqa: E402
                                                  init_nets)
from fashion_nerf_torch.train import m360  # noqa: E402
from fashion_nerf_torch.train.state import (  # noqa: E402
    clip_gradients, create_train_state, learning_rate)
from perfbench.reference import train_m360 as rtrain  # noqa: E402

SMALL = ["model.net_depth=4", "model.net_width=32", "model.skips=1",
         "model.bottleneck_width=32", "model.view_width=16",
         "proposal.net_depth=2", "proposal.net_width=16"]


def _c2w(theta, radius=1.0, phi=-0.3):
    pos = radius * np.array([math.cos(phi) * math.sin(theta),
                             -math.cos(phi) * math.cos(theta),
                             -math.sin(phi)])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


def _scene(n=3, H=8, W=12, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, H, W, 3)).astype(np.float32)
    poses = np.stack([_c2w(0.4 + 2.0 * i) for i in range(n)])
    return images, poses, 10.0


def _cfg(dtype="float32", batch=48, extra=()):
    return load_config("mipnerf360", SMALL + [
        f"model.compute_dtype={dtype}", f"train.batch_rays={batch}",
        *extra])


def _program(cfg, trees, images, poses, focal, seed, start):
    ds = RayDataset(images, poses, focal)
    gen = torch.Generator().manual_seed(seed)
    state = m360.state_from_trees(cfg, trees, gen)
    state.step = start
    return state, m360.M360TrainStep(cfg, ds), ds.batch_arrays()


def _leaves(state):
    return {f"{n}/{name}/{k}": getattr(layer, a)
            for n in ("proposal", "fine")
            for name, layer in getattr(state, n).named_dense()
            for k, a in (("kernel", "weight"), ("bias", "bias"))}


# --- the step against the reference -------------------------------------------

def _two_steps(start, plant=contextlib.nullcontext):
    """Two steps of the port's step in float32 on the CPU (with `plant`
    open) and the reference's from the same weights, scene and seed →
    (the port's losses, first gradients and change, the reference's)."""
    cfg = _cfg()
    images, poses, focal = _scene()
    nets = init_nets(cfg, torch.Generator().manual_seed(2))
    trees = {k: v.to_tree() for k, v in nets.items()}
    state, step, rays = _program(cfg, trees, images, poses, focal, 11, start)
    before = {k: v.detach().clone() for k, v in _leaves(state).items()}
    losses, grad = [], None
    with plant():
        for n in range(2):
            _, metrics = step(state, rays)
            losses.append(float(metrics["loss"]))
            if n == 0:
                opt = state.optimizer
                # the gradient as Adam holds it (none if Adam never ran)
                grad = {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                        / 0.1 for k, p in _leaves(state).items()}
    delta = {k: v.detach() - before[k] for k, v in _leaves(state).items()}
    want = rtrain.follow(config_to_dict(cfg), trees,
                         rtrain.scene_rays(torch.as_tensor(images), poses,
                                           focal, "cpu"),
                         focal, 11, start, 2, "cpu", rays_per_block=20)
    return losses, grad, delta, want


def _gap(got, ref):
    ref = ref.t() if ref.dim() == 2 else ref
    return float((got.reshape(ref.shape) - ref).norm() / ref.norm())


@pytest.mark.parametrize("start", [3, 1000])
def test_step_matches_the_reference(start):
    """Two steps of the port's step in float32 on the CPU against the
    reference from the same weights, scene and seed: each step's loss, and
    every leaf's first (clipped) gradient and the two steps' change, by
    their relative distance. The two compute the Gaussians in other forms
    (a closed-form diagonal against a 3 × 3 product), whose float32
    differences the IPE's top frequency (2¹¹) lifts to ~6e-5 a feature;
    measured: losses within 6e-6, the NeRF MLP's first layers' gradients
    within 1.1e-2 of their norm (sums over the batch that mostly cancel),
    the rest within 2e-3."""
    losses, grad, delta, want = _two_steps(start)
    for a, b in zip(losses, want["losses"]):
        assert a == pytest.approx(b, rel=2e-5)
    for k in want["grad"]:
        assert _gap(grad[k], want["grad"][k]) < 0.03, k
        assert _gap(delta[k], want["delta"][k]) < 0.03, k
    assert losses[0] > 0 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("fault", ["interlevel_to_nerf", "no_distortion",
                                   "half_batch", "stale"])
def test_planted_training_faults_leave_float32_rounding(fault):
    """The benchmark driver's planted faults that the CPU path reaches (all
    but the stale kept activation, which K7's backward on the card alone
    reads) move the same two steps past ten times what the test above
    allows: a loss by over 2e-4 of its value, or a leaf's gradient or
    change by over 0.3 of its norm (read on the CPU: the worst loss gap
    7.4e-4, 6.4e-3, 7.6e-2, 1.6e-2 and the worst leaf 8.2, 0.22, 1.16,
    1.0, in the order of the cases)."""
    from perfbench.drivers.train_m360 import FAULTS
    losses, grad, delta, want = _two_steps(1000, FAULTS[fault])
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(losses, want["losses"]))
    leaf_gap = max(max(_gap(grad[k], want["grad"][k]),
                       _gap(delta[k], want["delta"][k]))
                   for k in want["grad"])
    assert loss_gap > 2e-4 or leaf_gap > 0.3, (loss_gap, leaf_gap)


# --- the losses ---------------------------------------------------------------

def _sorted_edges(g, R, n):
    s = torch.sort(torch.rand((R, n + 1), generator=g, dtype=torch.float64),
                   dim=-1).values
    s[:, 0], s[:, -1] = 0.0, 1.0
    return s


def test_distortion_is_the_double_sum():
    g = torch.Generator().manual_seed(0)
    s = _sorted_edges(g, 5, 17)
    w = torch.rand((5, 17), generator=g, dtype=torch.float64)
    u = 0.5 * (s[:, 1:] + s[:, :-1])
    brute = sum(w[:, i] * w[:, j] * (u[:, i] - u[:, j]).abs()
                for i in range(17) for j in range(17))
    brute = brute + (w * w * (s[:, 1:] - s[:, :-1])).sum(-1) / 3.0
    assert float(m360.distortion(s, w)) == pytest.approx(
        float(brute.mean()), rel=1e-12)
    assert float(rtrain.distortion_sum(s, w).mean()) == pytest.approx(
        float(brute.mean()), rel=1e-12)


def test_interlevel_bound_is_the_overlapping_mass():
    """The prefix-sum bound against the intervals' overlap, pair by pair:
    a proposal interval counts for a NeRF interval when it ends after the
    NeRF interval begins and begins at or before it ends."""
    g = torch.Generator().manual_seed(1)
    s, s_p = _sorted_edges(g, 6, 9), _sorted_edges(g, 6, 23)
    w_p = torch.rand((6, 23), generator=g, dtype=torch.float64)
    got = m360.interlevel_bound(s, s_p, w_p)
    want = torch.zeros_like(got)
    for r in range(6):
        for i in range(9):
            for j in range(23):
                if s_p[r, j + 1] > s[r, i] and s_p[r, j] <= s[r, i + 1]:
                    want[r, i] += w_p[r, j]
    assert torch.allclose(got, want, rtol=1e-12)
    assert torch.allclose(rtrain.overlap_bound(s, s_p, w_p), want,
                          rtol=1e-12)


def test_the_stop_gradients():
    """The proposal's leaves get nothing from the data term or the
    distortion, the NeRF's nothing from the interlevel loss; each term
    moves the other net."""
    cfg = _cfg()
    images, poses, focal = _scene()
    nets = init_nets(cfg, torch.Generator().manual_seed(4))
    state, step, rays = _program(cfg, {k: v.to_tree() for k, v in
                                       nets.items()}, images, poses, focal,
                                 3, 1000)
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, rays["rays_o"].shape[0], (48,), generator=gen)
    batch = {k: v[idx] for k, v in rays.items()}
    out = m360.render_train(state, cfg, batch, torch.rand((48, 3),
                                                          generator=gen),
                            step.radius)
    terms = m360.losses(cfg, out, batch["rgb"])
    prop = list(state.proposal.parameters())
    fine = list(state.fine.parameters())

    def grads(term, params):
        return [g for g in torch.autograd.grad(
            terms[term], params, retain_graph=True, allow_unused=True)]

    for term in ("data", "distortion"):
        assert all(g is None or not g.any() for g in grads(term, prop))
        assert any(g is not None and g.any() for g in grads(term, fine))
    assert all(g is None or not g.any() for g in grads("interlevel", fine))
    assert any(g is not None and g.any()
               for g in grads("interlevel", prop))


# --- K7's backward ------------------------------------------------------------

def _ste_pack(net: MipMLP, bf16: bool):
    """A PackedWide of net's parameters under autograd: the weights rounded
    as `pack_wide` rounds them, the gradient passed through."""
    def ste(x):
        return x + (widefield._round(x, bf16) - x).detach()

    W = net.width
    w_h, w_a, bias = [], [], []
    for i, layer in enumerate(net.trunk):
        k = ste(layer.weight.t())
        w_h.append(k[:W] if i > 0 else None)
        w_a.append(None if (i > 0 and k.shape[0] == W) else
                   (k[W:] if i > 0 else k))
        bias.append(layer.bias)
    heads = {"sig": ste(net.sigma_head.weight[0]),
             "b_sig": net.sigma_head.bias[0]}
    if net.has_vd:
        kv = ste(net.view_0.weight.t())
        heads.update(bn=ste(net.feature.weight.t()), b_bn=net.feature.bias,
                     vb=kv[:net.bottleneck], dir=kv[net.bottleneck:],
                     b_view=net.view_0.bias, rgb=ste(net.rgb_head.weight.t()),
                     b_rgb=net.rgb_head.bias)
    return widefield.PackedWide(
        bf16=bf16, depth=net.depth, width=W, skips=net.skips, L=net.ipe_deg,
        L_dir=net.dir_deg, has_vd=net.has_vd, w_h=w_h, w_a=w_a, bias=bias,
        heads=heads)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["proposal", "fine"])
def test_k7_plain_backward_is_autograd_of_the_plain_forward(name, dtype):
    """`wide_field_train`'s gradients on the CPU (K7's plain backward,
    `wide_bwd_plain`) against autograd through `wide_rows_plain` at the
    same bf16 rounding points (float32 sums in another order: ~1e-7)."""
    cfg = _cfg(dtype)
    net = init_nets(cfg, torch.Generator().manual_seed(3))[name]
    bf16 = dtype == "bfloat16"
    g = torch.Generator().manual_seed(1)
    n, spr = 96, 8
    mean = torch.rand((n, 3), generator=g) * 2 - 1
    var = torch.rand((n, 3), generator=g) * 1e-2
    vd = torch.randn((n // spr, 3), generator=g) if net.has_vd else None
    g_rgb = torch.randn((n, 3), generator=g)
    g_sig = torch.randn((n,), generator=g)

    def objective(rgb, sigma):
        return (sigma * g_sig).sum() + (
            (rgb * g_rgb).sum() if rgb is not None else 0.0)

    params = list(net.parameters())
    got = torch.autograd.grad(objective(*widefield.wide_field_train(
        net, mean, var, vd, spr, bf16)), params)
    pk = _ste_pack(net, bf16)
    dp = widefield.dir_term(pk, vd) if net.has_vd else None
    want = torch.autograd.grad(objective(*widefield.wide_rows_plain(
        pk, mean, var, dp, spr)), params)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.allclose(a, b, rtol=1e-5,
                              atol=1e-6 * float(b.abs().max()) + 1e-12)


def test_k7_backward_slices_hold_the_transposes():
    """`_bwd_buffers`: each trunk layer's W_hᵀ, the bottleneck's and the
    view layer's transposes, unpacked from wgpack's order."""
    from fashion_nerf_torch.kernels import wgpack
    cfg = load_config("mipnerf360")
    net = init_nets(cfg, torch.Generator().manual_seed(0))["fine"]
    p = widefield.pack_wide(net)
    wpt = widefield._bwd_buffers(p)
    W = p.width
    lay = {"t": [(i - 1) * W * W for i in range(p.depth)],
           "bn": (p.depth - 1) * W * W}
    lay["vb"] = lay["bn"] + 256 * W
    assert wpt.numel() == lay["vb"] + 128 * 256

    def unpack(off, K_, N):
        out = torch.empty(K_, N)
        for nt in range(N // 256):
            for kb in range(K_ // 64):
                out[kb * 64:(kb + 1) * 64, nt * 256:(nt + 1) * 256] = \
                    wgpack._untile(wpt[off:off + 64 * 256].float(), 64, 256)
                off += 64 * 256
        return out

    assert torch.equal(unpack(lay["t"][5], W, W), p.w_h[5].t())
    assert torch.equal(unpack(lay["bn"], 256, W), p.heads["bn"].t())
    assert torch.equal(unpack(lay["vb"], 128, 256), p.heads["vb"].t())


@pytest.mark.parametrize("net,macs,row_bytes", [("fine", 15_420_160, 17_324),
                                                ("proposal", 412_160, 2_196)])
def test_backward_hand_counts(net, macs, row_bytes):
    """perfbench/m360_counts.py against its docstring's hand counts at the
    published widths: the backward's multiply-adds and bytes a row."""
    from perfbench import m360_counts
    tree = init_nets(load_config("mipnerf360"),
                     torch.Generator().manual_seed(0))[net].to_tree()
    assert m360_counts.bwd_macs(tree) == macs
    assert m360_counts.bwd_flops(tree) == 2 * macs
    assert m360_counts.bwd_bytes(tree) == row_bytes


# --- the optimizer -----------------------------------------------------------

def test_learning_rate_warms_up_then_decays_log_linearly():
    cfg = load_config("mipnerf360")
    for k in (0, 1, 100, 511, 512, 513, 4000, 250_000):
        ramp = 1e-8 + (1 - 1e-8) * math.sin(0.5 * math.pi * min(k / 512, 1))
        want = ramp * math.exp(math.log(2e-3) * (1 - k / 250_000)
                               + math.log(2e-5) * k / 250_000)
        assert learning_rate(cfg, k) == pytest.approx(want, rel=1e-12)
        assert rtrain.learning_rate(config_to_dict(cfg)["train"], k) == \
            pytest.approx(want, rel=1e-12)
    fern = load_config("llff_fern")
    assert learning_rate(fern, 700) == pytest.approx(
        5e-4 * 0.1 ** (700 / 250_000), rel=1e-12)


@pytest.mark.parametrize("scale", [1e-6, 1.0])
def test_clipping_scales_to_the_global_norm(scale):
    cfg = load_config("mipnerf360")
    g = torch.Generator().manual_seed(0)
    ps = [torch.zeros(s, requires_grad=True) for s in ((3, 4), (5,), (2,))]
    for p in ps:
        p.grad = torch.randn(p.shape, generator=g) * scale
    before = [p.grad.clone() for p in ps]
    norm = math.sqrt(sum(float((b * b).sum()) for b in before))
    clip_gradients(cfg, ps)
    mult = min(1.0, 1e-3 / (norm + float(np.finfo(np.float32).eps)))
    for p, b in zip(ps, before):
        assert torch.allclose(p.grad, b * mult, rtol=1e-6)
    off = load_config("llff_fern")
    for p, b in zip(ps, before):
        p.grad = b.clone()
    clip_gradients(off, ps)
    assert all(torch.equal(p.grad, b) for p, b in zip(ps, before))


def test_state_holds_mipmlps_and_the_published_adam():
    cfg = _cfg()
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               torch.Generator())
    assert state.coarse is None
    assert isinstance(state.proposal, MipMLP)
    assert isinstance(state.fine, MipMLP)
    assert sorted(state.nets()) == ["fine", "proposal"]
    grp = state.optimizer.param_groups[0]
    assert grp["eps"] == 1e-6 and grp["betas"] == (0.9, 0.999)
    n = sum(p.numel() for p in state.parameters())
    assert sum(p.numel() for p in grp["params"]) == n


# --- train() and the command line ---------------------------------------------

def _write_llff(root, n=5, H=64, W=96, focal=80.0):
    from fashion_nerf_torch.png import write_png
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows = []
    for i in range(n):
        img = rng.uniform(size=(H, W, 3))
        write_png(os.path.join(root, "images", f"{i:03d}.png"),
                  (img * 255).astype(np.uint8))
        c2w = np.zeros((3, 5), np.float32)
        c2w[:, 0] = [0, -1, 0]
        c2w[:, 1] = [1, 0, 0]
        c2w[:, 2] = [0, 0, 1]
        c2w[:, 3] = [0.1 * i, 0.05 * i, 0.0]
        c2w[:, 4] = [H, W, focal]
        rows.append(np.concatenate([c2w.reshape(-1), [1.0, 8.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return root


def _run_set(tmp_path):
    root = _write_llff(str(tmp_path / "scene"))
    return SMALL + ["model.compute_dtype=float32", "train.batch_rays=32",
                    "train.iters=4", "train.log_every=2",
                    "train.eval_every=4", "train.ckpt_every=4",
                    "render.chunk=96", f"data.root={root}"]


def test_train_runs_the_m360_step(tmp_path):
    from fashion_nerf_torch.train.loop import train
    cfg = load_config("mipnerf360", _run_set(tmp_path) + [
        f"out_dir={tmp_path / 'runs'}"])
    state, history = train(cfg, device="cpu")
    assert state.step == 4 and state.coarse is None
    assert isinstance(state.proposal, MipMLP)
    logs = [h for h in history if "loss" in h]
    assert len(logs) == 2 and all(math.isfinite(h["loss"]) for h in logs)
    assert any("val_psnr" in h and math.isfinite(h["val_psnr"])
               for h in history)


def test_cli_trains_evaluates_and_renders(tmp_path, capsys):
    from fashion_nerf_torch import cli
    sets = _run_set(tmp_path)
    base = ["--config", "mipnerf360", "--device", "cpu", "--out",
            str(tmp_path / "runs")]
    args = [a for s in sets for a in ("--set", s)]
    assert cli.main(["train", *base, *args]) == 0
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["done"] and done["steps"] == 4
    assert cli.main(["eval", *base, *args]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isfinite(row["psnr"]) and row["n_views"] >= 1
    assert cli.main(["render", *base, *args]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] > 0


# --- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _published(seed):
    return init_nets(load_config("mipnerf360"),
                     torch.Generator().manual_seed(seed))


def test_untile_inverts_the_activation_layout():
    x = torch.arange(128 * 192, dtype=torch.float32).view(128, 192)
    tiled = x.view(2, 8, 8, 3, 8, 8).permute(0, 3, 1, 4, 2, 5).reshape(-1)
    assert torch.equal(widefield.untile_rows(tiled, 128, 192), x)


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows", [("proposal", 131072),
                                       ("fine", 65536)])
def test_k7_backward_against_its_plain_version_on_the_card(dev, name, rows):
    """K7's training forward and backward at widths 256 and 1024 against
    their plain versions on the card, at the cell's samples a ray.

    The forward: its rgb and σ equal the render's kernels' bit for bit,
    and the plain version's up to the bf16 neighbour where f32 sums in
    another order round across (σ to 1e-2 of its spread, rgb to 1e-2: the
    flips carry from layer to layer, 7.8% of the NeRF MLP's last kept
    activations differ, and σ moved by up to 1.2e-3 at 131,072 proposal
    rows).

    The backward on the kernel's own kept activations against the plain
    backward on the same ones: the same bf16 operands and f32 sums in
    another order, so the cotangents round alike but where a sum lands
    across a bf16 boundary. Each leaf to 2e-3 of its norm (relative
    Frobenius distance). Two full plain runs (forward and backward) at f32
    and f64 differ by up to 2e-2 a leaf of the NeRF MLP, the forward's
    flips carried through eight layers: that is why the backward is held
    on common activations."""
    from fashion_nerf_torch import kernels as K
    net = _published(5)[name].to(dev)
    spr = 64 if name == "proposal" else 32
    g = torch.Generator(device=dev).manual_seed(6)
    mean = torch.rand((rows, 3), generator=g, device=dev) * 4 - 2
    var = torch.rand((rows, 3), generator=g, device=dev) * 1e-3
    vd = (torch.randn((rows // spr, 3), generator=g, device=dev)
          if net.has_vd else None)
    g_rgb = (torch.randn((rows, 3), generator=g, device=dev)
             if net.has_vd else None)
    g_sig = torch.randn((rows,), generator=g, device=dev)
    p = widefield.pack_wide(net)
    dp = widefield.dir_term(p, vd).contiguous() if net.has_vd else None
    b0, f0 = K.LAUNCHES["wide_field_bwd"], K.LAUNCHES["wide_field"]
    with torch.no_grad():
        rgb, sigma, saved = widefield._run_forward_train(p, mean, var, dp,
                                                         spr)
        got = widefield._run_backward(p, saved, g_rgb, g_sig, spr)
        rgb_r, sigma_r = widefield.wide_rows(p, mean, var, dp, spr)
        want = widefield.wide_bwd_plain(
            p, widefield.plain_saved(p, saved, rows), g_rgb, g_sig, spr)
        rgb_p, sigma_p = widefield.wide_rows_plain(p, mean, var, dp, spr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["wide_field_bwd"] == b0 + 1
    assert K.LAUNCHES["wide_field"] == f0 + 2
    assert torch.equal(sigma, sigma_r)
    assert float((sigma - sigma_p).abs().max()) < 1e-2 * max(
        float(sigma_p.std()), 1.0)
    if net.has_vd:
        assert torch.equal(rgb, rgb_r)
        assert float((rgb - rgb_p).abs().max()) < 1e-2

    def flat(gd):
        out = {f"{k}{i}": v for k in ("w_h", "w_a", "bias")
               for i, v in enumerate(gd[k]) if v is not None}
        out.update({k: gd[k] for k in ("sig", "bn", "b_bn", "vb", "b_view",
                                       "rgb", "b_rgb", "dirpart")
                    if k in gd})
        return out

    lg, lw = flat(got), flat(want)
    assert sorted(lg) == sorted(lw)
    for k in lw:
        rel = float((lg[k] - lw[k]).norm() / lw[k].norm().clamp(min=1e-30))
        assert rel < 2e-3, (k, rel)
