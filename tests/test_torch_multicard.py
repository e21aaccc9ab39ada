"""One rank a card: the device and backend policy of the port's
distribution (`dist.mesh.card_plan`, `init_distributed`, `describe`,
`kernels.resolve_device`), `kernels.on_cuda` on operands of one card or
several, and the kernel library's entries, each taking the ordinal of its
operands' card, parsed from csrc/. On the CPU: the card counts and the
launcher's variables are monkeypatched, and no group is made but the
one-rank gloo group of the last test."""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.dist import mesh as dmesh

PKG = Path(K.__file__).resolve().parents[1]
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def host(monkeypatch):
    """A host with `cards` CUDA devices and a rank the launcher started:
    host(cards, local_rank, local_world, world=None) sets torchrun's
    variables and CUDA's counts; set_device, init and init_process_group
    are recorded, not run (set_device makes its card the current one)."""
    calls = {"set_device": [], "init_process_group": []}
    current = [0]

    def set_device(d):
        calls["set_device"].append(d)
        current[0] = d

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def init_pg(backend, **kw):
        calls["init_process_group"].append((backend, kw))

    monkeypatch.setattr(dist, "init_process_group", init_pg)

    def make(cards, local_rank=0, local_world=1, world=None, launcher=True):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
        monkeypatch.setattr(torch.cuda, "current_device",
                            lambda: current[0])
        for k in LAUNCHER_VARS:
            monkeypatch.delenv(k, raising=False)
        world = local_world if world is None else world
        monkeypatch.setenv("WORLD_SIZE", str(world))
        monkeypatch.setenv("RANK", str(local_rank))
        if launcher:
            monkeypatch.setenv("LOCAL_RANK", str(local_rank))
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
        return calls

    return make


@pytest.mark.parametrize("local_rank", [0, 1, 2, 3])
def test_four_ranks_on_eight_cards_take_nccl_and_their_own_card(
        host, local_rank):
    calls = host(cards=8, local_rank=local_rank, local_world=4)
    assert dmesh.card_plan() == (local_rank, "nccl")
    assert dmesh.init_distributed() == "nccl"
    assert calls["set_device"] == [local_rank]
    assert K.resolve_device() == torch.device("cuda", local_rank)
    assert K.resolve_device("cuda") == torch.device("cuda", local_rank)
    (backend, kw), = calls["init_process_group"]
    assert backend == "nccl"
    assert kw["device_id"] == torch.device("cuda", local_rank)
    info = dmesh.describe(None, "nccl", K.resolve_device())
    assert info["device"] == f"cuda:{local_rank}"
    assert info["staging"] is None


@pytest.mark.parametrize("local_rank", [0, 1])
def test_two_ranks_sharing_one_card_take_gloo_on_cuda0(host, local_rank):
    """The one-card layout of the earlier slices: both ranks on cuda:0,
    gloo (NCCL refuses two ranks on one device), host-staged collectives;
    also without the launcher's LOCAL_* variables (ranks started by hand)."""
    for launcher in (True, False):
        calls = host(cards=1, local_rank=local_rank, local_world=2,
                     launcher=launcher)
        assert dmesh.card_plan() == (0, "gloo")
    assert dmesh.init_distributed(device="cuda") == "gloo"
    assert calls["set_device"] == [0]
    assert K.resolve_device() == torch.device("cuda", 0)
    (backend, kw), = calls["init_process_group"]
    assert backend == "gloo" and "device_id" not in kw
    info = dmesh.describe(None, "gloo", K.resolve_device())
    assert (info["device"], info["staging"]) == ("cuda:0", "host")


@pytest.mark.parametrize("cards,local_world", [(4, 8), (2, 3), (7, 8)])
def test_more_ranks_than_cards_raise_and_name_the_counts(host, cards,
                                                         local_world):
    calls = host(cards=cards, local_rank=1, local_world=local_world)
    for fn in (dmesh.card_plan, dmesh.init_distributed):
        with pytest.raises(RuntimeError,
                           match=f"{local_world} ranks on this host and "
                                 f"{cards} CUDA devices"):
            fn()
    assert calls["init_process_group"] == []


def test_the_cpu_takes_gloo(host):
    calls = host(cards=8, local_rank=1, local_world=2)
    assert K.resolve_device("cpu") == torch.device("cpu")
    assert dmesh.init_distributed(device="cpu") == "gloo"
    assert calls["set_device"] == []
    (backend, kw), = calls["init_process_group"]
    assert backend == "gloo" and "device_id" not in kw
    info = dmesh.describe(None, "gloo", torch.device("cpu"))
    assert (info["device"], info["staging"]) == ("cpu", None)


def test_a_failed_nccl_init_raises(host, monkeypatch):
    """No fallback: an NCCL group that cannot be made raises, and no gloo
    group is tried after it."""
    host(cards=2, local_rank=0, local_world=2)
    tried = []

    def refuse(backend, **kw):
        tried.append(backend)
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="NCCL error"):
        dmesh.init_distributed()
    assert tried == ["nccl"]


@pytest.mark.parametrize("cards,local_rank,local_world,world,launcher,"
                         "multihost,card", [
                             (8, 1, 1, 2, False, True, 0),
                             (8, 5, 1, 8, False, True, 0),
                             (8, 1, 2, 2, False, False, 1),
                             (8, 3, 4, 8, True, True, 3),
                             (1, 1, 2, 2, False, False, 0),
                         ])
def test_the_group_and_the_device_agree_on_the_card(
        host, cards, local_rank, local_world, world, launcher, multihost,
        card):
    """The card is decided once, by `init_distributed` (`card_plan`), and
    `resolve_device` gives it back after the join, whatever the layout:
    one rank a host (multihost, ranks started by hand with no LOCAL_*
    variables, 2 or 8 of them on hosts of 8 cards), ranks started by hand
    on one host, torchrun across hosts, ranks sharing one card."""
    calls = host(cards=cards, local_rank=local_rank, local_world=local_world,
                 world=world, launcher=launcher)
    backend = dmesh.init_distributed(multihost=multihost)
    assert calls["set_device"] == [card]
    assert K.resolve_device() == torch.device("cuda", card)
    assert K.resolve_device("cuda") == torch.device("cuda", card)
    (got, kw), = calls["init_process_group"]
    assert got == backend == ("nccl" if cards > 1 else "gloo")
    if backend == "nccl":
        assert kw["device_id"] == torch.device("cuda", card)


def test_one_process_makes_no_group(host):
    """Without a launcher (WORLD_SIZE 1) there is no group, and the device
    is torch's current card or the one named."""
    calls = host(cards=2, local_rank=0, local_world=1)
    assert dmesh.init_distributed() is None
    assert calls == {"set_device": [], "init_process_group": []}
    assert K.resolve_device() == torch.device("cuda", 0)
    assert K.resolve_device("cuda:1") == torch.device("cuda", 1)


def test_one_rank_a_host_across_hosts(host):
    """multihost without LOCAL_* variables: one rank a host, on its card 0."""
    host(cards=8, local_rank=5, local_world=1, world=8, launcher=False)
    assert dmesh.local_ranks(multihost=True) == (0, 1)
    assert dmesh.card_plan(multihost=True) == (0, "nccl")
    assert dmesh.local_ranks() == (5, 8)


def _on(*devs):
    return [None if d is None else SimpleNamespace(device=torch.device(d))
            for d in devs]


@pytest.mark.parametrize("devs,want", [
    (("cuda:1",), "cuda:1"),
    (("cuda:1", None, "cuda:1"), "cuda:1"),
    (("cuda:3", "cuda:3"), "cuda:3"),
    (("cuda:0",), "cuda:0"),
    (("cpu", None, "cpu"), None),
])
def test_on_cuda_gives_the_operands_card(devs, want):
    got = K.on_cuda(*_on(*devs))
    assert got == (None if want is None else torch.device(want))


@pytest.mark.parametrize("devs,match", [
    (("cuda:0", "cuda:1"), "one card"),
    (("cuda:2", None, "cuda:0"), "one card"),
    (("cpu", "cuda:1"), "all-CUDA"),
    (("cuda:0", "cpu"), "all-CUDA"),
])
def test_on_cuda_raises_on_mixed_devices(devs, match):
    with pytest.raises(ValueError, match=match):
        K.on_cuda(*_on(*devs))


# --- the library's entries, parsed from csrc/ --------------------------------

_CTYPES = {"int": ctypes.c_int, "long": ctypes.c_long,
           "float": ctypes.c_float}


def _entries() -> dict:
    """{name: (parameter declarations, body)} of every function defined in
    an extern "C" block of csrc/*.cu."""
    out = {}
    for src in sorted((PKG / "kernels" / "csrc").glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"',
                                text, re.S):
            for m in re.finditer(r"\n(?:const )?\w+\*? (fnt_\w+)\(([^)]*)\)"
                                 r" \{(.*?)\n\}", block, re.S):
                out[m.group(1)] = ([" ".join(p.split()) for p in
                                    m.group(2).split(",")], m.group(3))
    return out


def _ctype(decl: str):
    typ = decl.rsplit(" ", 1)[0].replace("const ", "")
    return ctypes.c_void_p if typ.endswith("*") else _CTYPES[typ]


@pytest.mark.parametrize("name", sorted(K._SIGNATURES))
def test_signatures_match_the_sources(name):
    """Each `_SIGNATURES` entry is an extern "C" definition with the same
    parameter types in the same order; an entry that takes a stream takes
    its device right before it, and before anything else makes it the
    current device for the call (`fnt::DeviceGuard`, which gives the
    thread's device back at the end, so torch's current device stays). An
    entry without a stream runs no CUDA call."""
    params, body = _entries()[name]
    assert [_ctype(p) for p in params] == K._SIGNATURES[name]
    if params[-1] == "void* stream":
        assert params[-2] == "int device"
        lines = [ln.strip() for ln in body.strip().splitlines()
                 if ln.strip() != "using namespace fnt;"]
        assert re.fullmatch(r"(fnt::)?DeviceGuard on\(device\);",
                            lines[0]), lines[0]
        assert lines[1] == "if (on.error()) return on.error();", lines[1]
    else:
        assert "device" not in " ".join(params)
        assert not re.search(r"\bcuda\w*\(", body)


def test_every_entry_with_a_stream_is_bound():
    """The twelve launching entries are bound, and the one bound entry
    that launches nothing is the host-side layout check."""
    launching = {n for n, (p, _) in _entries().items()
                 if p[-1] == "void* stream"}
    assert len(launching) == 12
    assert set(K._SIGNATURES) - launching == {"fnt_layout"}


def test_no_literal_device_in_the_sources():
    """No device-0 literal is left: every SM count, attribute and occupancy
    goes through the per-device helpers of fnt_common.cuh, which take the
    entry's ordinal."""
    csrc = PKG / "kernels" / "csrc"
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        assert not re.search(r"cudaDeviceGetAttribute\([^;]*,\s*0\s*\)",
                             text), src.name
        assert "cudaSetDevice(0)" not in text, src.name
        if src.name != "fnt_common.cuh":
            for call in ("cudaFuncSetAttribute", "cudaDeviceGetAttribute",
                         "cudaOccupancyMaxActiveBlocksPerMultiprocessor",
                         "cudaSetDevice"):
                assert call not in text, (src.name, call)


def test_every_wrapper_launches_on_its_operands_card():
    """Every call of a launching entry in the wrappers ends with the
    operands' device and stream (`kernels.launch_args`)."""
    calls = 0
    for path in sorted((PKG / "kernels").glob("*.py")) + [PKG / "probe.py"]:
        text = path.read_text()
        for m in re.finditer(r"\.(fnt_\w+)\(", text):
            if m.group(1) in ("fnt_layout", "fnt_error_string"):
                continue
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
            call = text[m.end():i - 1]
            assert re.search(r"\*K\.launch_args\([\w.]+\)\s*$", call), (
                path.name, m.group(1))
            calls += 1
    assert calls == 12


def test_a_group_of_one_takes_the_step_without_a_mesh_bitwise():
    """A process group of one rank (gloo on the CPU; NCCL on a card, in
    tests/test_torch_cuda.py and chip_smoke.py): three steps of TrainStep
    under make_mesh(1, 1), through the mesh's row split, gradient and
    scalar reductions, equal bit for bit to the steps without a mesh;
    `reduce_gradients`, `reduce_scalars` and `broadcast_` of a bool grid
    give back what they were given (`torch_dist_worker.group_of_one`)."""
    import torch_dist_worker as worker
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # one BLAS split for both runs
    cfg = load_config("blender_lego", [
        "model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
        "sampling.n_coarse=16", "sampling.n_fine=16", "train.batch_rays=64",
        "train.precrop_iters=0"])
    scene = make_synthetic_scene(n_views=2, H=16, W=16, n_samples=16)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    device="cpu")
    try:
        got = worker.group_of_one(cfg, ds, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert (got["backend"], got["card"]) == ("gloo", None)
    assert len(got["losses"]) == 3
    assert got["bitwise"] == {"losses": True, "grads": True, "params": True}
    assert all(got["collectives"].values()), got["collectives"]
    assert not dist.is_initialized()
