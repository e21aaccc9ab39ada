"""The program's own host ranges (`fashion_nerf_torch.trace.span`): their
names and nesting in a frame of `render_image_blockwise` and in a
`TrainStep`, one `fnt.chunk` a chunk and one `fnt.chunk.march` a chunk
some ray of which meets the occupancy box, no `record_function` entered
with the profiler off, and outputs bit for bit the same with the profiler
on and off. On the CPU (the kernels' plain versions), small nets and a
40×40 frame in 256-ray chunks; the kernels' ranges on the card (`cuda`)."""

import math

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fashion_nerf_torch import trace
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.core.cameras import generate_rays
from fashion_nerf_torch.core.occupancy import (build_occupancy,
                                               ray_aabb_intersect)
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.data.synthetic import make_synthetic_scene
from fashion_nerf_torch.dist import mesh as dmesh
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP
from fashion_nerf_torch.prng import GeneratorChain
from fashion_nerf_torch.render import blockwise as bw
from fashion_nerf_torch.train.loop import TrainStep
from fashion_nerf_torch.train.state import create_train_state

torch.set_num_threads(2)

IMG, CHUNK = 40, 256
FOCAL = 0.5 * IMG / math.tan(0.5 * 0.6911)
FRAME = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=4",
         "model.posenc_dir=2", "model.skips=0", "proposal.enabled=false",
         "occupancy.resolution=16", f"render.chunk={CHUNK}"]
STEP = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
        "sampling.n_coarse=16", "sampling.n_fine=16", "train.batch_rays=64",
        "train.precrop_iters=0"]
PHASES = ["fnt.step.gather", "fnt.step.forward", "fnt.step.backward",
          "fnt.step.reduce", "fnt.step.adam"]


def _c2w():
    c2w = torch.eye(4)[:3]
    c2w[2, 3] = 4.0
    return c2w.numpy()


def _ball(pts, dirs):
    """A ball of density of radius 0.6 at the origin."""
    sigma = 50.0 * (pts.norm(dim=-1) < 0.6).float()
    return torch.zeros_like(pts), sigma


def _frame_setup(device="cpu", extra=()):
    cfg = load_config("blender_lego", FRAME + list(extra))
    m = cfg.model
    with torch.random.fork_rng():
        torch.manual_seed(0)
        nets = {name: NeRFMLP(depth=m.net_depth, width=m.net_width,
                              skips=m.skips, posenc_xyz=m.posenc_xyz,
                              posenc_dir=m.posenc_dir,
                              compute_dtype=m.compute_dtype).to(device)
                for name in ("coarse", "fine")}
    o = cfg.occupancy
    occ = build_occupancy(_ball, o.world_min, o.world_max,
                          resolution=o.resolution,
                          sigma_threshold=o.sigma_threshold, macro=o.macro,
                          device=device)
    return cfg, nets, occ


def _frame(cfg, nets, occ, device="cpu"):
    with torch.no_grad():
        return bw.render_image_blockwise(nets, cfg, IMG, IMG, FOCAL, _c2w(),
                                         occ=occ, device=device)


def _live_chunks(cfg, occ) -> int:
    """The chunks some ray of which meets the occupancy box, from the slab
    test on the frame's rays in 8×8 pixel-block order."""
    rays_o, rays_d = generate_rays(IMG, IMG, FOCAL, _c2w())
    order, _ = bw._tile_order(IMG, IMG)
    order = torch.from_numpy(order)
    _, _, hit = ray_aabb_intersect(rays_o.reshape(-1, 3)[order],
                                   rays_d.reshape(-1, 3)[order], occ.box_min,
                                   occ.box_max, cfg.render.near,
                                   cfg.render.far)
    return sum(bool(hit[c:c + CHUNK].any())
               for c in range(0, hit.shape[0], CHUNK))


def _ranges(prof):
    """[(name, start µs, end µs, nearest enclosing fnt.* range's name or
    None)] of the trace's fnt.* host ranges, in start order (not their
    copies on the device's timeline)."""
    out = []
    for e in prof.events():
        if (not e.name.startswith("fnt.")
                or e.device_type != DeviceType.CPU):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("fnt."):
            up = up.cpu_parent
        out.append((e.name, e.time_range.start, e.time_range.end,
                    None if up is None else up.name))
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _step_setup(mesh=None):
    cfg = load_config("blender_lego", STEP)
    scene = make_synthetic_scene(n_views=2, H=16, W=16, n_samples=16)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    device="cpu")
    chain = GeneratorChain(cfg.train.seed)
    state = create_train_state(cfg, chain.once("init"),
                               chain.once("run", "cpu"), "cpu")
    return state, TrainStep(cfg, ds, mesh=mesh), ds.batch_arrays()


@pytest.fixture(scope="module")
def frame_trace():
    cfg, nets, occ = _frame_setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(cfg, nets, occ)
    return cfg, occ, _ranges(prof)


@pytest.mark.parametrize("name, parent", [
    ("fnt.frame", None), ("fnt.frame.rays", "fnt.frame"),
    ("fnt.frame.pack", "fnt.frame"), ("fnt.chunk", "fnt.frame"),
    ("fnt.chunk.cull", "fnt.chunk"), ("fnt.chunk.march", "fnt.chunk"),
    ("fnt.rays.culling", "fnt.chunk.march"),
    ("fnt.rays.coarse", "fnt.chunk.march"),
    ("fnt.rays.pdf", "fnt.chunk.march"), ("fnt.rays.fine", "fnt.chunk.march"),
    ("fnt.frame.unchunk", "fnt.frame")])
def test_frame_ranges_nest(frame_trace, name, parent):
    """Every range of the name is there and sits inside its parent."""
    _, _, ranges = frame_trace
    got = [r for r in ranges if r[0] == name]
    assert got, name
    assert {r[3] for r in got} == {parent}


def test_one_chunk_range_a_chunk_and_one_march_a_live_chunk(frame_trace):
    cfg, occ, ranges = frame_trace
    count = {n: sum(1 for r in ranges if r[0] == n)
             for n in ("fnt.frame", "fnt.chunk", "fnt.chunk.cull",
                       "fnt.chunk.march")}
    n_chunks = -(-IMG * IMG // CHUNK)
    live = _live_chunks(cfg, occ)
    assert 0 < live < n_chunks          # the frame has chunks of both kinds
    assert count == {"fnt.frame": 1, "fnt.chunk": n_chunks,
                     "fnt.chunk.cull": n_chunks, "fnt.chunk.march": live}


@pytest.mark.parametrize("with_mesh", [False, True])
def test_train_step_phases_in_order(with_mesh):
    """One CPU TrainStep: fnt.step around the gather, forward, backward,
    the mesh's reduction (a mesh of one rank only) and Adam, in order."""
    if with_mesh:
        dmesh.bind_group("gloo", None, store=torch.distributed.HashStore(),
                         rank=0, world_size=1)
    try:
        mesh = dmesh.make_mesh(1, 1) if with_mesh else None
        state, step, rays = _step_setup(mesh)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, rays)
    finally:
        if with_mesh:
            dmesh.shutdown_distributed()
    ranges = _ranges(prof)
    assert [r[0] for r in ranges if r[0] == "fnt.step"] == ["fnt.step"]
    phases = [r for r in ranges if r[0].startswith("fnt.step.")]
    want = [p for p in PHASES if with_mesh or p != "fnt.step.reduce"]
    assert [r[0] for r in phases] == want
    assert {r[3] for r in phases} == {"fnt.step"}
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_no_record_function_with_the_profiler_off(monkeypatch):
    """With no profiler a span is the one shared null context: a frame
    and a step enter no record_function."""
    entered = []
    monkeypatch.setattr(trace, "record_function", entered.append)
    assert trace.span("fnt.a") is trace.span("fnt.b")
    cfg, nets, occ = _frame_setup()
    _frame(cfg, nets, occ)
    state, step, rays = _step_setup()
    step(state, rays)
    assert entered == []


def _step_out(profiled: bool):
    state, step, rays = _step_setup()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            _, metrics = step(state, rays)
    else:
        _, metrics = step(state, rays)
    return {"loss": metrics["loss"],
            **{str(i): p.detach() for i, p in enumerate(state.parameters())}}


def _frame_out(profiled: bool):
    cfg, nets, occ = _frame_setup()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            return _frame(cfg, nets, occ)
    return _frame(cfg, nets, occ)


@pytest.mark.parametrize("run", [_frame_out, _step_out],
                         ids=["frame", "step"])
def test_outputs_bitwise_with_the_profiler_on_and_off(run):
    off, on = run(False), run(True)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("extra, kernel", [
    (["kernels.fused_carry=true"], "fnt.kernel.slim_march"),
    (["kernels.fused_carry=false"], "fnt.kernel.field")],
    ids=["carry", "twostage"])
def test_kernel_ranges_inside_the_marches_on_the_card(extra, kernel):
    """On the card the kernels' wrappers open their ranges inside the
    chunk's marches, and the frame is the same bit for bit with the
    profiler on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg, nets, occ = _frame_setup(dev, extra)
    off = _frame(cfg, nets, occ, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = _frame(cfg, nets, occ, dev)
        torch.cuda.synchronize(dev)
    for k in off:
        gap = (off[k].float() - on[k].float()).abs().max()
        assert torch.equal(off[k], on[k]), (k, float(gap))
    ranges = _ranges(prof)
    got = [r for r in ranges if r[0] == kernel]
    assert got, sorted({r[0] for r in ranges})
    assert {r[3] for r in got} <= {"fnt.rays.coarse", "fnt.rays.fine"}, (
        {r[3] for r in got})
