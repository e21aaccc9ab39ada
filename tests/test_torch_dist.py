"""The port's distribution (`fashion_nerf_torch.dist`, the mesh-aware
`TrainStep`, `train` and `render_image`) against the JAX package's, on
the CPU: the port's ranks are processes of one gloo group
(tests/torch_dist_worker.py), the reference runs on its 8 virtual CPU
devices with `kernels.use_pallas=false`, as its own distributed tests
(tests/distributed) do.

Three groups of processes start once, together, and serve every test:
- two ranks: dp=2 and dp=1×tp=2 steps, dp=2 steps with their own draws
  (jitter, precrop), `segmented_ray_scan` at 2 segments, `render_image`
  over dp=2, `train` under `dist.tp=2` and a one-process checkpoint
  restored under tp=2;
- four ranks: dp=4 and dp=2×tp=2 steps, `param_shardings` of
  blender_lego's tree, `segmented_ray_scan` at 4 segments;
- two ranks started by hand (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT):
  `python -m fashion_nerf_torch train --set dist.dp=2
  --set dist.multihost=true`, whose checkpoint is restored in one process.

Tolerances are the reference's own (tests/distributed/test_dp.py,
test_segmented.py): losses at rtol 5e-3 (1e-3 for dp×tp), under 1% of
parameters more than 1e-4 apart after 3 Adam steps, rgb and acc 3e-4,
depth 3e-3, the sharded render 1e-5."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.core.volrend import volume_render as j_volume_render
from fashion_nerf.data.pipeline import RayDataset as JRayDataset
from fashion_nerf.data.synthetic import make_synthetic_scene
from fashion_nerf.dist.mesh import make_mesh as j_make_mesh
from fashion_nerf.dist.mesh import param_shardings as j_param_shardings
from fashion_nerf.dist.mesh import shard_state as j_shard_state
from fashion_nerf.dist.segmented import segmented_ray_scan as j_segmented
from fashion_nerf.train.loop import make_train_step as j_make_train_step
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch import ckpt
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.dist import mesh as dmesh
from fashion_nerf_torch.prng import GeneratorChain
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import (create_train_state,
                                            state_from_params)

import torch_dist_worker as worker

torch.set_num_threads(2)

# the reference's distributed tests' nets (tests/distributed/test_dp.py:18)
OVR = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=4",
       "model.posenc_dir=2", "sampling.n_coarse=8", "sampling.n_fine=8",
       "train.batch_rays=64", "train.precrop_iters=0",
       "kernels.use_pallas=false"]
# the reference comparison has no per-ray draws: the port's cannot be the
# reference's (another generator), so the batches and the prior's points
# are fed to both sides
FED = OVR + ["sampling.perturb=false"]
F32 = "model.compute_dtype=float32"
N_STEPS = 3
RTOL, ATOL, RTOL_TP = 5e-3, 1e-4, 1e-3
PARAM_GAP, PARAM_SHARE = 1e-4, 0.01
SEG_ATOL = {"rgb": 3e-4, "acc": 3e-4, "depth": 3e-3}
RENDER_ATOL = 1e-5
CLI_OVR = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
           "sampling.n_coarse=8", "train.batch_rays=32", "train.iters=3",
           "train.log_every=1", "train.ckpt_every=3", "train.eval_every=3",
           "data.root="]


def _flat(prefix: str, tree, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _seg_case(rng, R=16, S=64):
    return dict(rgb=rng.uniform(0, 1, (R, S, 3)).astype(np.float32),
                sigma=rng.normal(0.5, 2.0, (R, S)).astype(np.float32),
                t=np.sort(rng.uniform(2, 6, (R, S)), -1).astype(np.float32),
                d=rng.normal(size=(R, 3)).astype(np.float32),
                white=np.array(True))


def _wall_case(R=4, S=32):
    sigma = np.full((R, S), -100.0, np.float32)
    sigma[:, 3] = 1e6
    return dict(rgb=np.broadcast_to(np.float32([0.2, 0.9, 0.4]),
                                    (R, S, 3)).copy(),
                sigma=sigma,
                t=np.broadcast_to(np.linspace(2.0, 6.0, S, dtype=np.float32),
                                  (R, S)).copy(),
                d=np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (R, 3)).copy(),
                white=np.array(False))


def _steps(name, dp, tp, overrides, streamed=True):
    return dict(kind="steps", name=name, dp=dp, tp=tp, config="blender_lego",
                overrides=overrides, streamed=streamed, n_steps=N_STEPS,
                seed=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the three groups, compute the references while they run, and
    join them → (the results, the references)."""
    tmp = tmp_path_factory.mktemp("dist")
    cfg = j_load_config("blender_lego", FED)
    scene = make_synthetic_scene(n_views=2, H=8, W=8, n_samples=8)
    jds = JRayDataset(scene["images"], scene["poses"], scene["focal"])
    host = {k: np.asarray(v) for k, v in jds.batch_arrays().items()}
    rng = np.random.default_rng(0)
    batches = [{k: v[idx] for k, v in host.items()} for idx in
               (rng.integers(0, jds.n_rays, 64) for _ in range(N_STEPS))]
    jstate = j_create(cfg, jax.random.PRNGKey(0))
    params = jax.device_get(jstate.params)
    key, sparsity = jstate.key, []
    for _ in range(N_STEPS):     # the prior's points of the reference's steps
        key, _, k_render = jax.random.split(key, 3)
        sparsity.append(np.asarray(jax.random.uniform(
            jax.random.fold_in(k_render, 17),
            (cfg.train.sparsity_points, 1, 3),
            minval=cfg.occupancy.world_min, maxval=cfg.occupancy.world_max)))
    inputs = {"scene/images": scene["images"], "scene/poses": scene["poses"],
              "scene/focal": np.float32(scene["focal"]),
              "scene/val_image": scene["val_image"],
              "scene/val_pose": scene["val_pose"],
              "render/pose": np.eye(4, dtype=np.float32)[:3]}
    inputs["render/pose"][2, 3] = 4.0
    for k in ("coarse", "fine"):
        _flat(f"params/{k}", params[k], inputs)
    for s, b in enumerate(batches):
        for k, v in b.items():
            inputs[f"batch{s}/{k}"] = v
        inputs[f"sparsity{s}"] = sparsity[s]
    seg_rng = np.random.default_rng(0)
    cases = {"seg": _seg_case(seg_rng), "wall": _wall_case()}
    for c, arrs in cases.items():
        for k, v in arrs.items():
            inputs[f"{c}/{k}"] = v
    np.savez(tmp / "inputs.npz", **inputs)

    # a one-process checkpoint for the tp=2 restore
    small = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
             "sampling.n_coarse=8", "train.batch_rays=32", "train.iters=2",
             "train.log_every=1", "train.ckpt_every=2",
             "train.eval_every=100", "data.root=", f"out_dir={tmp / 'one'}"]
    with torch.enable_grad():
        loop.train(load_config("tiny_lego", small), log_fn=lambda e: None,
                   device="cpu")
    one_ckpt = str(tmp / "one" / "tiny_lego" / "ckpt")

    tp_train = ["dist.tp=2", "model.net_depth=2", "model.net_width=32",
                "model.posenc_xyz=2", "sampling.n_coarse=8",
                "train.batch_rays=32", "train.iters=3", "train.log_every=1",
                "train.eval_every=3", "train.ckpt_every=100",
                f"out_dir={tmp / 'tp'}"]
    jobs = {
        "two": [_steps("dp2", 2, 1, FED), _steps("tp2", 1, 2, FED),
                _steps("dp2_f32", 2, 1, FED + [F32]),
                _steps("dp2_draws", 2, 1, OVR + ["train.precrop_iters=2"],
                       streamed=False),
                dict(kind="segmented", name="seg2", cases=["seg", "wall"]),
                dict(kind="render", name="render", dp=2, tp=1,
                     config="blender_lego",
                     overrides=OVR + ["render.chunk=16"], H=8, W=8,
                     focal=10.0),
                dict(kind="train", name="train_tp2", config="tiny_lego",
                     overrides=tp_train),
                dict(kind="restore", name="restore", dp=1, tp=2,
                     config="tiny_lego", overrides=small, ckpt_dir=one_ckpt,
                     every_rank=True)],
        "four": [_steps("dp4", 4, 1, FED), _steps("dp2tp2", 2, 2, FED),
                 dict(kind="shardings", name="shardings", dp=2, tp=2,
                      config="blender_lego", overrides=[]),
                 dict(kind="segmented", name="seg4", cases=["seg", "wall"])],
    }
    groups = {}
    for name, tasks in jobs.items():
        (tmp / name).mkdir()
        groups[name] = worker.run_job(
            str(tmp / f"{name}.json"), 2 if name == "two" else 4,
            str(tmp / "inputs.npz"), str(tmp / name), tasks)
    cli_out = tmp / "cli"
    argv = [sys.executable, "-m", "fashion_nerf_torch", "train", "--config",
            "tiny_lego", "--device", "cpu", "--out", str(cli_out)]
    for o in CLI_OVR + ["dist.dp=2", "dist.multihost=true"]:
        argv += ["--set", o]
    groups["cli"] = worker.start([argv] * 2)

    # the references, while the groups run
    ref = {"losses": {}, "params": {}}
    devs = jax.devices("cpu")
    for label, (dp, tp) in (("dp8", (8, 1)), ("dp4tp2", (4, 2))):
        mesh = j_make_mesh(dp=dp, tp=tp, devices=devs[:8])
        state = j_shard_state(mesh, j_create(cfg, jax.random.PRNGKey(0)))
        step = j_make_train_step(cfg, jds, mesh=mesh, streamed=True)
        losses = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        ref["losses"][label] = losses
        ref["params"][label] = _port_names(cfg, jax.device_get(state.params))
    ref["scene"] = scene
    ref["single"] = _single(batches, sparsity, params, scene)
    ref["single_f32"] = _single(batches, sparsity, params, scene, [F32])
    ref["draws"] = _single_draws(params, scene)
    ref["seg"] = {}
    for n_seg in (2, 4):
        mesh = Mesh(np.array(devs[:n_seg]), ("sp",))
        for c, a in cases.items():
            args = [jnp.asarray(a[k]) for k in ("rgb", "sigma", "t", "d")]
            ref["seg"][(n_seg, c)] = {
                "reference": {k: np.asarray(v) for k, v in j_segmented(
                    mesh, *args, white_bkgd=bool(a["white"])).items()},
                "volume_render": {k: np.asarray(v) for k, v in
                                  j_volume_render(*args, white_bkgd=bool(
                                      a["white"])).items()}}
    full = j_load_config("blender_lego")
    ref["shardings"] = j_param_shardings(
        j_make_mesh(dp=4, tp=2, devices=devs[:8]),
        j_create(full, jax.random.PRNGKey(0)).params)

    outs = {name: worker.join(procs, name) for name, procs in groups.items()}
    res = {f.stem: torch.load(f, weights_only=False)
           for name in jobs for f in (tmp / name).glob("*.pt")}
    res["cli_stdout"] = outs["cli"][0][0]
    res["cli_stdout_1"] = outs["cli"][1][0]
    res["cli_stderr"] = [e for _, e in outs["cli"]]
    res["cli_ckpt"] = str(cli_out / "tiny_lego" / "ckpt")
    return res, ref, tmp


def _port_names(cfg, params) -> dict:
    state = state_from_params(cfg, params, torch.Generator())
    return {f"{n}.{p}": t.detach() for n, net in state.nets().items()
            for p, t in net.named_parameters()}


def _single(batches, sparsity, params, scene, extra=()):
    """The port's one-process steps on the fed batches and points."""
    cfg = load_config("blender_lego", FED + list(extra))
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    state = state_from_params(cfg, params, torch.Generator().manual_seed(0))
    step = loop.TrainStep(cfg, ds, streamed=True)
    losses, grads = [], None
    for s, b in enumerate(batches):
        with torch.enable_grad():
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()},
                            sparsity_pts=torch.from_numpy(
                                sparsity[s].copy()))
        losses.append(float(m["loss"]))
        if s == 0:
            grads = {f"{n}.{p}": t.grad.detach().clone()
                     for n, net in state.nets().items()
                     for p, t in net.named_parameters()}
    return {"losses": losses, "grads": grads, "params": {
        f"{n}.{p}": t.detach() for n, net in state.nets().items()
        for p, t in net.named_parameters()}}


def _single_draws(params, scene):
    """The port's one-process steps drawing their own batches, jitter and
    points (precrop for the first two)."""
    cfg = load_config("blender_lego", OVR + ["train.precrop_iters=2"])
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    state = state_from_params(cfg, params, torch.Generator().manual_seed(0))
    step = loop.TrainStep(cfg, ds)
    losses = []
    for _ in range(N_STEPS):
        with torch.enable_grad():
            state, m = step(state, ds.batch_arrays())
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": {
        f"{n}.{p}": t.detach() for n, net in state.nets().items()
        for p, t in net.named_parameters()}}


def _far_share(a: dict, b: dict) -> float:
    """The share of parameter elements more than PARAM_GAP apart."""
    bad = sum(int(((a[k] - b[k]).abs() > PARAM_GAP).sum()) for k in b)
    return bad / sum(v.numel() for v in b.values())


@pytest.mark.parametrize("name", ["dp2", "dp4"])
def test_dp_matches_reference_and_one_process(run, name):
    res, ref, _ = run
    got = res[name]
    for label, other in (("the reference's dp=8", ref["losses"]["dp8"]),
                         ("one process", ref["single"]["losses"])):
        np.testing.assert_allclose(got["losses"], other, rtol=RTOL,
                                   atol=ATOL, err_msg=label)
    assert _far_share(got["params"], ref["params"]["dp8"]) < PARAM_SHARE
    assert _far_share(got["params"], ref["single"]["params"]) < PARAM_SHARE


def test_dp2_reduced_gradients_are_the_one_process_gradients(run):
    """In f32: under bf16 compute each rank's partial weight gradient is
    rounded to bf16 before the sum (the cast's backward), which moves the
    reduced gradient by ~2e-3 relative; in f32 only the order of the sums
    differs."""
    res, ref, _ = run
    for k, g in ref["single_f32"]["grads"].items():
        d = (res["dp2_f32"]["grads"][k] - g).norm() / g.norm().clamp_min(
            1e-30)
        assert float(d) < 1e-5, k


def test_dp2_draws_its_rows_of_the_one_process_draws(run):
    """Jitter, batch indices (the precrop's and the whole set's) and the
    prior's points drawn at the global shape: the same steps."""
    res, ref, _ = run
    got = res["dp2_draws"]
    np.testing.assert_allclose(got["losses"], ref["draws"]["losses"],
                               rtol=RTOL, atol=ATOL)
    assert _far_share(got["params"], ref["draws"]["params"]) < PARAM_SHARE


@pytest.mark.parametrize("name,label", [("tp2", None),
                                        ("dp2tp2", "dp4tp2")])
def test_tp_matches_reference_and_one_process(run, name, label):
    res, ref, _ = run
    got = res[name]
    if label:
        np.testing.assert_allclose(got["losses"], ref["losses"][label],
                                   rtol=RTOL_TP, atol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["single"]["losses"],
                               rtol=RTOL, atol=ATOL)
    assert _far_share(got["params"], ref["single"]["params"]) < PARAM_SHARE
    shapes = got["shard_shapes"]
    assert any(s for *_, s in shapes)
    for (master, moment, sharded) in shapes:
        assert master == moment


def test_param_shardings_match_reference(run):
    """Leaf by leaf on blender_lego's tree: the port's column shards are
    the reference's P(None, "tp") kernels and P("tp") biases."""
    res, ref, _ = run
    got = res["shardings"]
    seen = 0
    for name, path in got["paths"].items():
        net, layer, kind = path
        spec = ref["shardings"][net]["params"][layer][kind].spec
        want = "shard0" if "tp" in tuple(spec) else "replicate"
        assert got["placements"][name] == ["replicate", want], name
        seen += want != "replicate"
    # trunk 8 + feature + view_0, kernels and biases, in two nets
    assert seen == 2 * 2 * 10


@pytest.mark.parametrize("n_seg", [2, 4])
def test_segmented_ray_scan_matches_reference(run, n_seg):
    res, ref, _ = run
    got = res[f"seg{n_seg}"]
    for against in ("reference", "volume_render"):
        want = ref["seg"][(n_seg, "seg")][against]
        for k, tol in SEG_ATOL.items():
            np.testing.assert_allclose(got["seg"][k].numpy(), want[k],
                                       atol=tol, err_msg=f"{against} {k}")
    wall = got["wall"]
    np.testing.assert_allclose(wall["depth"].numpy(), 2.0 + 3 * 4.0 / 31,
                               atol=1e-3)
    np.testing.assert_allclose(wall["rgb"].numpy(),
                               np.broadcast_to([0.2, 0.9, 0.4], (4, 3)),
                               atol=1e-4)


def test_render_image_over_dp_matches_one_process(run):
    res, _, _ = run
    got = res["render"]
    np.testing.assert_allclose(got["mesh"]["rgb"].numpy(),
                               got["single"]["rgb"].numpy(), atol=RENDER_ATOL)
    np.testing.assert_allclose(got["mesh"]["depth"].numpy(),
                               got["single"]["depth"].numpy(), atol=1e-4)


def test_train_under_tp2_runs(run):
    """`loop.train` of `dist.tp=2` under two ranks (it raised before the
    mesh was ported): sharded, finite, and the one-process run's losses."""
    res, ref, tmp = run
    got = res["train_tp2"]
    assert got["sharded"]
    cfg = load_config("tiny_lego", [
        "model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
        "sampling.n_coarse=8", "train.batch_rays=32", "train.iters=3",
        "train.log_every=1", "train.eval_every=3", "train.ckpt_every=100",
        f"out_dir={tmp / 'tp1'}"])
    with torch.enable_grad():
        _, hist = loop.train(cfg, dataset_dict=ref["scene"],
                             log_fn=lambda e: None, device="cpu")
    loss = [h["loss"] for h in got["history"] if "loss" in h]
    np.testing.assert_allclose(loss, [h["loss"] for h in hist if "loss" in h],
                               rtol=RTOL, atol=ATOL)
    psnr = [h["val_psnr"] for h in got["history"] if "val_psnr" in h]
    assert len(psnr) == 1 and np.isfinite(psnr[0])


def test_one_process_checkpoint_restores_under_tp2(run):
    res, _, _ = run
    payload = torch.load(os.path.join(
        str(run[2] / "one" / "tiny_lego" / "ckpt"), "step_00000002.pt"),
        weights_only=True)
    moments = payload["optimizer"]["state"]
    for r in (0, 1):
        got = res[f"restore.{r}"]
        assert got["tp_rank"] == r
        full = got["params"]
        names = [f"{n}.{p}" for n in ("coarse",)
                 for p in payload["nets"][n]]
        for name in names:
            net, p = name.split(".", 1)
            torch.testing.assert_close(full[name], payload["nets"][net][p])
        for i, (m, s) in enumerate(zip(got["masters"], got["sharded"])):
            want = moments[i]["exp_avg"]
            if s:
                want = want.chunk(2, 0)[r]
            torch.testing.assert_close(got["exp_avg"][i], want)
        assert any(got["sharded"])


def test_env_started_two_process_train_matches_one_process(run, capsys):
    """`python -m fashion_nerf_torch train --set dist.dp=2 --set
    dist.multihost=true` on two processes started by hand (the analogue of
    tests/distributed/test_multihost.py): the mesh line, rank 0's logs
    against one process's, and its checkpoint restored in one process."""
    from fashion_nerf_torch import cli
    res, _, tmp = run
    for err in res["cli_stderr"]:
        line = [ln for ln in err.splitlines() if ln.startswith('{"mesh"')]
        assert len(line) == 1
        assert json.loads(line[0])["mesh"] == {"dp": 2, "tp": 1}
        assert json.loads(line[0])["backend"] == "gloo"
    logs = [json.loads(ln.split(" ", 1)[1]) for ln in
            res["cli_stdout"].splitlines()
            if ln.startswith('[fashion-nerf-torch] {"loss"')]
    assert json.loads(res["cli_stdout"].splitlines()[-1])["steps"] == 3
    assert res["cli_stdout_1"].strip() == ""        # rank 1 logs nothing
    argv = ["train", "--config", "tiny_lego", "--device", "cpu", "--out",
            str(tmp / "cli1")]
    for o in CLI_OVR:
        argv += ["--set", o]
    assert cli.main(argv) == 0
    one = [json.loads(ln.split(" ", 1)[1]) for ln in
           capsys.readouterr().out.splitlines()
           if ln.startswith('[fashion-nerf-torch] {"loss"')]
    assert len(logs) == len(one) == 3
    np.testing.assert_allclose([e["loss"] for e in logs],
                               [e["loss"] for e in one], rtol=RTOL, atol=ATOL)
    # the two-rank checkpoint in one process, against the one-process run's
    cfg = load_config("tiny_lego", CLI_OVR)
    chain = GeneratorChain(0)
    restored = ckpt.restore(res["cli_ckpt"], create_train_state(
        cfg, chain.once("init"), chain.once("run")))
    single = ckpt.restore(str(tmp / "cli1" / "tiny_lego" / "ckpt"),
                          create_train_state(cfg, chain.once("init2"),
                                             chain.once("run2")))
    assert restored.step == single.step == 3
    a = {f"{n}.{p}": t.detach() for n, net in restored.nets().items()
         for p, t in net.named_parameters()}
    b = {f"{n}.{p}": t.detach() for n, net in single.nets().items()
         for p, t in net.named_parameters()}
    assert _far_share(a, b) < PARAM_SHARE
    assert dmesh.world_size() == 1
