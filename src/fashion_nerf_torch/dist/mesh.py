"""Process groups, the ("dp", "tp") mesh and the tensor-parallel rule;
counterpart of `fashion_nerf.dist.mesh`.

The reference places one jitted program on a JAX mesh and XLA inserts the
collectives. The port runs one process per rank on `torch.distributed`
(started by `python -m torch.distributed.run`) and writes each collective
itself:

- DP over rays. Every rank holds the same generator state, draws the
  global batch's indices and every per-ray random tensor at the global
  shape and keeps its own rows (`ray_sharding`, `prng.RowDraws`). The loss
  is the local mean times the rows' share of the global batch (the local
  sum over the global ray count), and `reduce_gradients` sums
  the gradients over the ranks before Adam. So a step equals the
  single-process step up to the order of float sums.
- TP. The leaves the reference's `_tp_rule` shards over "tp" (the Dense
  kernels and biases of the trunk, `feature` and `view_0`, along their
  output features) are stored, with their Adam moments, as this rank's
  column shards (`shard_state`, `ShardedAdam`). The fused field kernels K3 and
  K4 take the whole net, as the reference's Pallas custom call sees whole
  weights under GSPMD, so after every Adam update the shards are gathered
  over "tp" into the full weights the next step packs.

Devices and backends are chosen, never fallen back to (`card_plan`): on
a host with a card for each of its ranks, rank LOCAL_RANK runs on
cuda:LOCAL_RANK and the group is NCCL, whose collectives stay on the
cards; on a host with one card, its ranks share cuda:0 over gloo (NCCL
refuses two ranks on one device), which takes CUDA tensors in all_reduce,
broadcast and all_gather and stages them through host memory; the CPU is
gloo. Any other count of ranks and cards raises. `init_distributed`
makes the rank's card torch's current device, `kernels.resolve_device`
gives that card, so every tensor of a rank lives there, and the kernels
launch on their operands' card (`kernels.on_cuda`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("dp", "tp")
GROUP_TIMEOUT_S = 600     # a collective that waits longer raises


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """True on the rank that logs and writes checkpoints: rank 0, or the
    one process."""
    return rank() == 0


def local_ranks(multihost: bool = False) -> tuple:
    """(this process's index among its host's ranks, the host's ranks), as
    the launcher says (torch.distributed.run's LOCAL_RANK and
    LOCAL_WORLD_SIZE); without them every rank is on this host unless
    multihost, then one rank a host."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank_ = int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     1 if multihost else world))
    local_rank = int(os.environ.get("LOCAL_RANK", 0 if multihost else rank_))
    return local_rank, local_world


def card_plan(multihost: bool = False) -> tuple:
    """(this rank's card, the backend) on a CUDA host: rank LOCAL_RANK on
    cuda:LOCAL_RANK over NCCL when the host has a card for each of its
    ranks; every rank on cuda:0 over gloo when the host has one card (NCCL
    refuses two ranks on one device). Raises on any other count: more
    ranks than cards, more than one card."""
    local_rank, local_world = local_ranks(multihost)
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("no CUDA device for the ranks")
    if local_world <= cards:
        return local_rank, "nccl"
    if cards == 1:
        return 0, "gloo"
    raise RuntimeError(
        f"{local_world} ranks on this host and {cards} CUDA devices: one "
        f"rank a card needs {local_world} cards, and ranks share a card "
        "only on a host that shows one (CUDA_VISIBLE_DEVICES)")


def init_distributed(multihost: bool = False, device=None) -> Optional[str]:
    """Join the process group the launcher describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, as torch.distributed.run sets them) and
    return its backend. A single process (no launcher, WORLD_SIZE 1) is a
    no-op returning None, as in the reference; a process already in a
    group returns that group's backend. multihost: the ranks span hosts,
    one a host unless LOCAL_WORLD_SIZE says otherwise (the same env://
    rendezvous serves one host or many). device: the ranks' device (CUDA
    unless the CPU is asked for by name). On CUDA the rank's card
    (`card_plan`) becomes torch's current device (`bind_group`), so a
    rank's `kernels.resolve_device()` is its card from here on."""
    if dist.is_initialized():
        return dist.get_backend()
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if device is not None and torch.device(device).type == "cpu":
        backend, card = "gloo", None
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card "
                               "(pass device cpu to run the plain versions)")
        card, backend = card_plan(multihost)
    bind_group(backend, card, init_method="env://")
    return backend


def bind_group(backend: str, card: Optional[int] = None, **kw) -> None:
    """`init_process_group(backend, **kw)` for this process, on `card`
    when one is given: it becomes torch's current device first, and an
    NCCL group is bound to it (`device_id`: its communicator is made now,
    and a failure raises here, with no other backend tried)."""
    if card is not None:
        torch.cuda.set_device(card)
        torch.cuda.init()
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", card)
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)


def shutdown_distributed() -> None:
    """Leave the process group, if in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(dp: int = -1, tp: int = 1):
    """A DeviceMesh with dims ("dp", "tp") over the process group's ranks
    (rank = dp index · tp + tp index). dp=-1 takes world // tp. A gloo
    mesh is typed "cpu": its collectives run on the host."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with python "
                           "-m torch.distributed.run")
    world = world_size()
    if dp == -1:
        dp = world // tp
    if dp < 1 or dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have "
                         f"{world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dp, tp), mesh_dim_names=AXES)


def resolve_mesh(dcfg):
    """The mesh of a DistConfig (the CLI's train calls this): dp=-1 fills
    the ranks; a 1×1 mesh is None (the single-process path). Raises when
    dp·tp is not the number of ranks."""
    world = world_size()
    tp = dcfg.tp
    dp = dcfg.dp if dcfg.dp != -1 else max(world // tp, 1)
    n = dp * tp
    if n != world:
        raise ValueError(f"dist config dp={dp} tp={tp} needs {n} ranks; "
                         f"have {world} (start them with python -m "
                         f"torch.distributed.run --nproc_per_node {n})")
    if n <= 1:
        return None
    return make_mesh(dp=dp, tp=tp)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def describe(mesh, backend: Optional[str], device) -> dict:
    """The `{"mesh": …}` line the CLI prints to stderr: the rank's device
    (cuda:N or cpu) and where its collectives stage CUDA tensors ("host"
    under gloo, None under NCCL and on the CPU)."""
    dev = torch.device(device)
    return {"mesh": {a: axis_size(mesh, a) for a in AXES},
            "backend": backend, "world": world_size(), "rank": rank(),
            "device": str(dev),
            "staging": ("host" if backend == "gloo" and dev.type == "cuda"
                        else None)}


def ray_sharding(mesh, n: int) -> slice:
    """The rows of an n-ray batch this rank takes: its block of the "dp"
    axis, the same on every rank of its "tp" group."""
    dp = axis_size(mesh, "dp")
    if n % dp:
        raise ValueError(f"{n} rays do not split over dp={dp}")
    k, r = n // dp, axis_rank(mesh, "dp")
    return slice(r * k, (r + 1) * k)


def _tp_rule(mesh):
    """The reference's rule, per leaf → its placements over ("dp", "tp").

    tp=1: everything replicated. tp>1: Dense kernels of the trunk,
    `feature` and `view_*` shard their output features over "tp"
    (column-parallel; the port's weight is (out, in), so dim 0), and so do
    their biases, when tp divides them; heads and everything else stay
    replicated. rule(path, leaf): path is the reference's names (net,
    layer, "kernel" or "bias"), leaf the port's tensor."""
    from torch.distributed.tensor import Replicate, Shard
    tp = axis_size(mesh, "tp")

    def rule(path, leaf):
        rep = (Replicate(), Replicate())
        if tp == 1 or leaf.ndim == 0:
            return rep
        in_trunk = any(n.startswith(("trunk_", "feature", "view_"))
                       for n in path)
        if (in_trunk and "kernel" in path and leaf.ndim == 2
                and leaf.shape[0] % tp == 0):
            return (Replicate(), Shard(0))
        if (in_trunk and "bias" in path and leaf.ndim == 1
                and leaf.shape[0] % tp == 0):
            return (Replicate(), Shard(0))
        return rep

    return rule


def reference_paths(state) -> dict:
    """{the port's parameter name "net.module.param": the reference's path}:
    (net, layer, "kernel" | "bias") for the fields' Dense layers through
    `NeRFMLP.named_dense` (the name map `load_flax_params` uses), (net,
    *the port's dotted name) for the encoder and the latent table."""
    out = {}
    for net_name, net in state.nets().items():
        dense = {}
        for layer_name, layer in getattr(net, "named_dense", list)():
            dense[id(layer.weight)] = (net_name, layer_name, "kernel")
            dense[id(layer.bias)] = (net_name, layer_name, "bias")
        for pname, p in net.named_parameters():
            out[f"{net_name}.{pname}"] = dense.get(
                id(p), (net_name, *pname.split(".")))
    return out


def param_shardings(mesh, state) -> dict:
    """{the port's parameter name: its placements over ("dp", "tp")}, per
    leaf the reference's `_tp_rule` decision. Adam's moments follow their
    parameters."""
    rule = _tp_rule(mesh)
    paths = reference_paths(state)
    params = {f"{n}.{p}": t for n, net in state.nets().items()
              for p, t in net.named_parameters()}
    return {name: rule(paths[name], params[name]) for name in params}


def shard_state(mesh, state):
    """Place a TrainState on the mesh. tp=1: unchanged, every rank holds
    the whole state. tp>1: its optimizer becomes a `ShardedAdam` over this
    rank's column shards of the leaves `_tp_rule` shards; the nets keep
    the full weights."""
    if axis_size(mesh, "tp") > 1:
        state.optimizer = ShardedAdam(mesh, state)
    return state


class ShardedAdam:
    """Adam over this rank's column shards of a TrainState's tp-sharded
    leaves, in the optimizer's place (`shard_state`).

    masters: Adam's parameters, in the full optimizer's order; a sharded
    leaf's master is its shard (its moments shard with it), a replicated
    leaf's the leaf itself. `step` cuts the reduced gradients of the full
    weights to the shards, runs Adam (`adam`) and gathers the full weights
    over "tp", which the next step packs for K3 and K4. `state_dict` is the
    single-process layout (the shards' moments gathered: every rank of the
    tp group calls it); `load_state_dict` takes one, and the shards from
    the full weights (a restore loads the nets first)."""

    def __init__(self, mesh, state):
        from torch.distributed.tensor import Shard
        self.group = mesh.get_group("tp")
        self.tp, self.rank = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
        rule = _tp_rule(mesh)
        paths = reference_paths(state)
        names = {id(t): f"{n}.{p}" for n, net in state.nets().items()
                 for p, t in net.named_parameters()}
        old = state.optimizer
        self.full = list(old.param_groups[0]["params"])
        self.sharded = [isinstance(rule(paths[names[id(p)]], p)[1], Shard)
                        for p in self.full]
        self.masters = [torch.nn.Parameter(self.cut(p.detach()).clone())
                        if s else p for p, s in zip(self.full, self.sharded)]
        self.adam = type(old)(self.masters, **old.defaults)
        self.adam.load_state_dict(self._cut_state(old.state_dict()))

    @property
    def param_groups(self) -> list:
        return self.adam.param_groups

    def cut(self, t):
        """This rank's block of t along dim 0."""
        return t.chunk(self.tp, 0)[self.rank]

    def _gather(self, shards: list) -> list:
        """The full tensors of equal-ranked shards: one all_gather over
        "tp" of their concatenation, reassembled along dim 0."""
        local = torch.cat([s.reshape(-1) for s in shards])
        parts = [torch.empty_like(local) for _ in range(self.tp)]
        dist.all_gather(parts, local, group=self.group)
        sizes = [s.numel() for s in shards]
        pieces = [p.split(sizes) for p in parts]
        return [torch.cat([pieces[r][j].view(s.shape)
                           for r in range(self.tp)], 0)
                for j, s in enumerate(shards)]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.full + self.masters:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for m, p, s in zip(self.masters, self.full, self.sharded):
            if s:
                m.grad = None if p.grad is None else self.cut(
                    p.grad).contiguous()
        self.adam.step()
        idx = [i for i, s in enumerate(self.sharded) if s]
        for i, t in zip(idx, self._gather([self.masters[i] for i in idx])):
            self.full[i].copy_(t)

    def state_dict(self) -> dict:
        sd = self.adam.state_dict()
        state = {i: dict(v) for i, v in sd["state"].items()}
        idx = [i for i, s in enumerate(self.sharded) if s and i in state]
        for key in ("exp_avg", "exp_avg_sq"):
            for i, t in zip(idx, self._gather([state[i][key]
                                               for i in idx]) if idx else []):
                state[i][key] = t
        return {"state": state, "param_groups": sd["param_groups"]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for m, p, s in zip(self.masters, self.full, self.sharded):
            if s:
                m.copy_(self.cut(p))
        self.adam.load_state_dict(self._cut_state(sd))

    def _cut_state(self, sd: dict) -> dict:
        """The single-process layout's state_dict cut to this rank's
        shards."""
        state = {i: dict(v) for i, v in sd["state"].items()}
        for i, s in enumerate(self.sharded):
            if s and i in state:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[i][key] = self.cut(state[i][key]).clone()
        return {"state": state, "param_groups": sd["param_groups"]}


def _sum_over_ranks(mesh, flat):
    """flat summed over every rank in one all_reduce, divided by tp: the
    dp ranks hold partial sums of the global batch's terms, the tp ranks
    of one dp block copies of the same. Every rank gets the same result."""
    dist.all_reduce(flat)
    tp = axis_size(mesh, "tp")
    return flat / tp if tp > 1 else flat


def reduce_gradients(mesh, params) -> None:
    """Replace the gradients of `params` by their sum over the ranks
    (`_sum_over_ranks`). Every rank's graph has the same leaves."""
    ps = [p for p in params if p.grad is not None]
    if not ps:
        return
    flat = _sum_over_ranks(mesh, torch.cat([p.grad.reshape(-1) for p in ps]))
    for p, g in zip(ps, flat.split([p.numel() for p in ps])):
        p.grad.copy_(g.view_as(p.grad))


def reduce_scalars(mesh, values: dict) -> dict:
    """{name: 0-d tensor} summed over the ranks (`_sum_over_ranks`)."""
    flat = torch.stack([v.detach().float() for v in values.values()])
    return dict(zip(values, _sum_over_ranks(mesh, flat).unbind()))


def broadcast_(tensors, src: int = 0) -> None:
    """Overwrite every rank's tensors with rank src's, in place (bool
    tensors travel as uint8)."""
    for t in tensors:
        if t.dtype == torch.bool:
            u = t.to(torch.uint8)
            dist.broadcast(u, src)
            t.copy_(u.bool())
        else:
            dist.broadcast(t, src)
