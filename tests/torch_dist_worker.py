"""One rank of the port's multi-process tests (tests/test_torch_dist.py on
the CPU, tests/test_torch_cuda.py on the card), and the helpers that start
and join a group of them.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py JOB.json

Joins the group the environment describes (gloo: on the CPU, or ranks
sharing one card; NCCL: one rank a card), runs the job's tasks in order on the job's device
(every rank runs every task) and has rank 0 write each task's results to
OUT/<task name>.pt. The inputs come from the job's npz: the scene, the
batches, the parameters and the segmented scan's arrays. Imports torch and
the port only.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from fashion_nerf_torch.config import load_config  # noqa: E402
from fashion_nerf_torch.dist import mesh as dmesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120      # a group that takes longer is killed and fails


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(argvs, env: dict = None) -> list:
    """Start one process per argv as the ranks of one group (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT set by hand, the port's src on
    the path, one thread each)."""
    port, world = free_port(), len(argvs)
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "XLA_FLAGS", "LOCAL_WORLD_SIZE")}
    base.update(env or {}, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                PYTHONPATH=os.path.join(REPO, "src"))
    return [subprocess.Popen(argv, env=dict(base, RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r, argv in enumerate(argvs)]


def join(procs, label: str) -> list:
    """Wait for the group → [(stdout, stderr)]; kill it and raise when it
    outlasts JOIN_TIMEOUT_S, raise when a rank failed."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"{label}: the group did not finish in "
                           f"{JOIN_TIMEOUT_S} s") from None
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{label} rank failed ({p.returncode}):\n"
                               f"{out}\n{err[-4000:]}")
    return outs


def run_job(path: str, world: int, inputs: str, out: str, tasks: list,
            device: str = "cpu", env: dict = None) -> list:
    """Write a job and start `world` workers on it (join them later), with
    `env` added to their environment."""
    with open(path, "w") as f:
        json.dump({"inputs": inputs, "out": out, "tasks": tasks,
                   "device": device}, f)
    return start([[sys.executable, os.path.abspath(__file__), path]] * world,
                 env=env)


def tree(inputs, prefix: str) -> dict:
    """The nested parameter tree stored flat under "prefix/a/b/..."."""
    out = {}
    for key in inputs.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = inputs[key]
    return out


def full_params(state) -> dict:
    return {f"{n}.{p}": t.detach().cpu() for n, net in state.nets().items()
            for p, t in net.named_parameters()}


def task_steps(task, inputs, mesh):
    """n Adam steps of TrainStep under the mesh from the reference's
    parameters: the loss of each, the reduced gradients of the first, the
    full parameters after the last."""
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.train.loop import TrainStep
    from fashion_nerf_torch.train.state import state_from_params
    cfg = load_config(task["config"], task["overrides"])
    dev = DEVICE
    ds = RayDataset(inputs["scene/images"], inputs["scene/poses"],
                    float(inputs["scene/focal"]), device=dev)
    state = state_from_params(cfg, tree(inputs, "params"), torch.Generator(
        device=dev).manual_seed(task["seed"]), device=dev)
    state = dmesh.shard_state(mesh, state)
    step = TrainStep(cfg, ds, streamed=task["streamed"], mesh=mesh)
    losses, grads, shard_shapes = [], None, None
    for k in range(task["n_steps"]):
        if task["streamed"]:
            rows = step.rows
            batch = {key: torch.from_numpy(inputs[f"batch{k}/{key}"][rows]
                                           ).to(dev)
                     for key in ("rays_o", "rays_d", "viewdirs", "rgb",
                                 "frame_ids")}
        else:
            batch = ds.batch_arrays()
        pts = (torch.from_numpy(inputs[f"sparsity{k}"]).to(dev)
               if task["streamed"] else None)
        with torch.enable_grad():
            state, metrics = step(state, batch, sparsity_pts=pts)
        losses.append(float(metrics["loss"]))
        if k == 0:
            grads = {f"{n}.{p}": t.grad.detach().cpu()
                     for n, net in state.nets().items()
                     for p, t in net.named_parameters()}
            opt = state.optimizer
            if isinstance(opt, dmesh.ShardedAdam):
                local = opt.adam.state_dict()["state"]
                shard_shapes = [
                    (tuple(m.shape), tuple(local[i]["exp_avg"].shape), s)
                    for i, (m, s) in enumerate(zip(opt.masters,
                                                   opt.sharded))]
    return {"losses": losses, "grads": grads, "params": full_params(state),
            "shard_shapes": shard_shapes}


def task_shardings(task, inputs, mesh):
    """param_shardings of a fresh state of the config, as strings."""
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.train.state import create_train_state
    cfg = load_config(task["config"], task["overrides"])
    chain = GeneratorChain(0)
    state = create_train_state(cfg, chain.once("init"), chain.once("run"))
    return {"placements": {k: [f"shard{p.dim}" if p.is_shard()
                               else "replicate" for p in v] for k, v in
                           dmesh.param_shardings(mesh, state).items()},
            "paths": dmesh.reference_paths(state)}


def task_segmented(task, inputs, mesh):
    """segmented_ray_scan over the world: each rank passes its segment."""
    from fashion_nerf_torch.dist.segmented import segmented_ray_scan
    out = {}
    for case in task["cases"]:
        rgb, sigma, t, d = (torch.from_numpy(inputs[f"{case}/{k}"]).to(
            DEVICE) for k in ("rgb", "sigma", "t", "d"))
        n, r = dmesh.world_size(), dmesh.rank()
        k = sigma.shape[1] // n
        cols = slice(r * k, (r + 1) * k)
        got = segmented_ray_scan(None, rgb[:, cols], sigma[:, cols],
                                 t[:, cols], d,
                                 white_bkgd=bool(inputs[f"{case}/white"]))
        out[case] = {key: v.cpu() for key, v in got.items()}
    return out


def task_render(task, inputs, mesh):
    """render_image of the parameters with the mesh and without it."""
    from fashion_nerf_torch.render.renderer import render_image
    from fashion_nerf_torch.kernels.posenc_mlp import field_for
    from fashion_nerf_torch.train.state import state_from_params
    cfg = load_config(task["config"], task["overrides"])
    state = state_from_params(cfg, tree(inputs, "params"),
                              torch.Generator())
    field_c = field_f = field_for(cfg)
    fc = (lambda pts, vd, *c: field_c(state.coarse, pts, vd, *c))
    ff = (lambda pts, vd, *c: field_f(state.fine, pts, vd, *c))
    pose = torch.from_numpy(inputs["render/pose"])
    H, W, focal = task["H"], task["W"], task["focal"]
    with torch.no_grad():
        sharded = render_image(fc, ff, H, W, focal, pose, cfg, device="cpu",
                               mesh=mesh)
        single = render_image(fc, ff, H, W, focal, pose, cfg, device="cpu")
    return {"mesh": sharded, "single": single}


def task_train(task, inputs, mesh):
    """loop.train of the config: the mesh comes from its dist section."""
    from fashion_nerf_torch.train import loop
    cfg = load_config(task["config"], task["overrides"])
    scene = {k[len("scene/"):]: inputs[k] for k in inputs.files
             if k.startswith("scene/")}
    scene["focal"] = float(scene["focal"])
    with torch.enable_grad():
        state, hist = loop.train(cfg, dataset_dict=scene,
                                 log_fn=lambda e: None, device="cpu")
    return {"history": hist, "params": full_params(state),
            "sharded": isinstance(state.optimizer, dmesh.ShardedAdam)}


def task_restore(task, inputs, mesh):
    """A single-process checkpoint restored under the mesh: the full
    weights, and this rank's shards of the weights and of Adam's moments."""
    from fashion_nerf_torch import ckpt
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.train.state import create_train_state
    cfg = load_config(task["config"], task["overrides"])
    chain = GeneratorChain(1)
    state = create_train_state(cfg, chain.once("init"), chain.once("run"))
    state = dmesh.shard_state(mesh, state)
    ckpt.restore(task["ckpt_dir"], state)
    opt = state.optimizer
    local = opt.adam.state_dict()["state"]
    return {"params": full_params(state),
            "masters": [m.detach().clone() for m in opt.masters],
            "exp_avg": [local[i]["exp_avg"].clone()
                        for i in range(len(opt.masters))],
            "sharded": list(opt.sharded),
            "tp_rank": dmesh.axis_rank(mesh, "tp")}


def group_of_one(cfg, ds, device, n: int = 3) -> dict:
    """The collectives' plumbing at world size 1: a process group of this
    one process (`dist.mesh.bind_group` over an in-process store: NCCL
    bound to the card, gloo on the CPU), n TrainSteps of the run's seed
    under make_mesh(1, 1) against the same steps without a mesh, and
    `reduce_gradients`, `reduce_scalars` and `broadcast_` of a bool
    occupancy grid; leaves the group. → {"backend", "card" (torch's
    current device, None on the CPU), "losses", "launches" (K3, K4 and K5
    launches of the mesh's steps), "bitwise": {"losses", "grads",
    "params"}: the mesh's steps equal bit for bit to the steps without,
    "collectives": {name: gave back what it was given}}."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.train.loop import TrainStep
    from fashion_nerf_torch.train.state import create_train_state
    device = torch.device(device)

    def steps(mesh):
        chain = GeneratorChain(cfg.train.seed)
        state = create_train_state(cfg, chain.once("init"),
                                   chain.once("run", device), device)
        step = TrainStep(cfg, ds, mesh=mesh)
        losses, grads = [], None
        for k in range(n):
            with torch.enable_grad():
                state, m = step(state, ds.batch_arrays())
            losses.append(float(m["loss"]))
            if k == 0:
                grads = [p.grad.clone() for p in state.parameters()]
        return losses, grads, [p.detach().clone()
                               for p in state.parameters()]

    cuda = device.type == "cuda"
    backend = "nccl" if cuda else "gloo"
    dmesh.bind_group(backend, device.index if cuda else None,
                     store=torch.distributed.HashStore(), rank=0,
                     world_size=1)
    try:
        mesh = dmesh.make_mesh(1, 1)
        kinds = ("field", "field_bwd", "volrend")
        n0 = {k: K.LAUNCHES[k] for k in kinds}
        got = steps(mesh)
        launches = {k: K.LAUNCHES[k] - n0[k] for k in kinds}
        want = steps(None)
        g = torch.Generator(device=device).manual_seed(3)
        params = [torch.nn.Parameter(torch.randn(s, generator=g,
                                                 device=device))
                  for s in ((256, 63), (256,), (3, 128))]
        for p in params:
            p.grad = torch.randn(p.shape, generator=g, device=device)
        sent = [p.grad.clone() for p in params]
        dmesh.reduce_gradients(mesh, params)
        scalars = {"loss": torch.tensor(0.25, device=device),
                   "psnr": torch.tensor(21.5, device=device)}
        summed = dmesh.reduce_scalars(mesh, scalars)
        grid = torch.rand((128,) * 3, generator=g, device=device) > 0.7
        before = grid.clone()
        dmesh.broadcast_([grid])
        return {
            "backend": torch.distributed.get_backend(),
            "card": torch.cuda.current_device() if cuda else None,
            "losses": got[0], "launches": launches,
            "bitwise": {"losses": got[0] == want[0], **{
                k: all(torch.equal(x, y) for x, y in zip(a, b))
                for k, a, b in (("grads", got[1], want[1]),
                                ("params", got[2], want[2]))}},
            "collectives": {
                "reduce_gradients": all(torch.equal(p.grad, t)
                                        for p, t in zip(params, sent)),
                "reduce_scalars": all(torch.equal(summed[k], v)
                                      for k, v in scalars.items()),
                "broadcast_": (grid.dtype == torch.bool
                               and torch.equal(grid, before))}}
    finally:
        dmesh.shutdown_distributed()


def task_whoami(task, inputs, mesh):
    """This rank's group backend, its device and torch's current card."""
    from fashion_nerf_torch.kernels import resolve_device
    return {"backend": torch.distributed.get_backend(),
            "device": str(resolve_device(DEVICE)),
            "card": (torch.cuda.current_device()
                     if torch.cuda.is_available() else None)}


TASKS = {"steps": task_steps, "whoami": task_whoami, "shardings": task_shardings,
         "segmented": task_segmented, "render": task_render,
         "train": task_train, "restore": task_restore}


DEVICE = "cpu"


def main() -> int:
    global DEVICE
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        job = json.load(f)
    DEVICE = job.get("device", "cpu")
    inputs = np.load(job["inputs"])
    dmesh.init_distributed(device=DEVICE)
    for task in job["tasks"]:
        mesh = (dmesh.make_mesh(task["dp"], task["tp"]) if "dp" in task
                else None)
        result = TASKS[task["kind"]](task, inputs, mesh)
        if dmesh.rank() == 0 or task.get("every_rank"):
            name = task["name"] + (f".{dmesh.rank()}"
                                   if task.get("every_rank") else "")
            torch.save(result, os.path.join(job["out"], name + ".pt"))
    dmesh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
