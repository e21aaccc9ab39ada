"""The `data.stream` path of the port against the JAX package's, on the
CPU: `host_batch_iter` (the reference's numpy draws, batch for batch),
`prefetch_to_device` (the iterator's batches, a rank's rows of them), the
streamed step fed through both packages' prefetch, and `train` with
`data.stream=true` in one process (the batches it trains on are
`host_batch_iter`'s). Small nets, `kernels.use_pallas=false`, as the
reference's own tests of the pipeline run."""

import jax
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.data import pipeline as jpipe
from fashion_nerf.data.synthetic import make_synthetic_scene
from fashion_nerf.train.loop import make_train_step as j_make_train_step
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.data import pipeline
from fashion_nerf_torch.dist.mesh import ray_sharding
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import state_from_params

torch.set_num_threads(2)

OVR = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=4",
       "model.posenc_dir=2", "sampling.n_coarse=8", "sampling.n_fine=8",
       "train.batch_rays=64", "train.precrop_iters=0",
       "kernels.use_pallas=false", "sampling.perturb=false"]


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=2, H=8, W=8, n_samples=8)


@pytest.fixture(scope="module")
def datasets(scene):
    jds = jpipe.RayDataset(scene["images"], scene["poses"], scene["focal"])
    tds = pipeline.RayDataset(scene["images"], scene["poses"],
                              scene["focal"])
    return jds, tds


def test_host_batch_iter_equals_reference(datasets):
    """Five batches, index for index: from the same arrays bitwise, from
    each package's own ray set within its ray generation's rounding."""
    jds, tds = datasets
    host = {k: np.asarray(v) for k, v in jds.batch_arrays().items()}
    ref = jpipe.host_batch_iter(jds.batch_arrays(), 48, seed=3)
    same = pipeline.host_batch_iter(host, 48, seed=3)
    own = pipeline.host_batch_iter(tds.batch_arrays(), 48, seed=3)
    for _ in range(5):
        r, s, o = next(ref), next(same), next(own)
        assert set(r) == set(s) == set(o)
        for k in r:
            np.testing.assert_array_equal(s[k], r[k])
        np.testing.assert_array_equal(o["frame_ids"], r["frame_ids"])
        np.testing.assert_array_equal(o["rgb"], r["rgb"])
        for k in ("rays_o", "rays_d", "viewdirs"):
            np.testing.assert_allclose(o[k], r[k], atol=1e-6)


@pytest.mark.parametrize("rows", [None, (1, 2)])
def test_prefetch_to_device_yields_the_iterators_batches(rows):
    """On the CPU the batches come through as they are: all of them, in
    order, each cut to a dp rank's rows when asked."""
    rng = np.random.default_rng(0)
    batches = [{"a": rng.normal(size=(8, 3)).astype(np.float32),
                "b": rng.integers(0, 9, 8)} for _ in range(5)]

    class Mesh:      # the two attributes ray_sharding reads
        shape, mesh_dim_names = (2, 1), ("dp", "tp")

        @staticmethod
        def get_local_rank(axis):
            return rows[0] if axis == "dp" else 0

    sl = None if rows is None else ray_sharding(Mesh, 8)
    got = list(pipeline.prefetch_to_device(iter(batches), size=2,
                                           device="cpu", rows=sl))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        for k in b:
            want = b[k] if sl is None else b[k][4:8]
            np.testing.assert_array_equal(g[k].numpy(), want)
            assert g[k].device.type == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "case")
def test_prefetch_to_device_defaults_to_the_card():
    """Without a device the batches go to the card, as every entry point's
    do: with no CUDA device that raises instead of filling host tensors."""
    it = pipeline.prefetch_to_device(iter([{"a": np.zeros(4)}]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(it)


def test_streamed_steps_match_reference_through_prefetch(scene, datasets):
    """Three steps each side fed through its own package's
    host_batch_iter → prefetch_to_device from the same seed: the
    reference's parameters carried across, the prior's points fed."""
    jds, tds = datasets
    cfg = j_load_config("blender_lego", OVR)
    jstate = j_create(cfg, jax.random.PRNGKey(0))
    params = jax.device_get(jstate.params)
    jstep = j_make_train_step(cfg, jds, streamed=True)
    jit = jpipe.prefetch_to_device(jpipe.host_batch_iter(
        jds.batch_arrays(), cfg.train.batch_rays, seed=5), size=2)
    tcfg = load_config("blender_lego", OVR)
    state = state_from_params(tcfg, params, torch.Generator())
    step = loop.TrainStep(tcfg, tds, streamed=True)
    tit = pipeline.prefetch_to_device(pipeline.host_batch_iter(
        tds.batch_arrays(), tcfg.train.batch_rays, seed=5), size=2,
        device="cpu")
    for _ in range(3):
        _, _, k_render = jax.random.split(jstate.key, 3)
        pts = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k_render, 17),
            (cfg.train.sparsity_points, 1, 3),
            minval=cfg.occupancy.world_min, maxval=cfg.occupancy.world_max)))
        jb, tb = next(jit), next(tit)
        np.testing.assert_array_equal(tb["frame_ids"].numpy(),
                                      np.asarray(jb["frame_ids"]))
        jstate, jm = jstep(jstate, jb)
        with torch.enable_grad():
            state, tm = step(state, tb, sparsity_pts=pts)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=5e-3, abs=1e-4)


def test_train_streamed_trains_on_host_batch_iter(scene, monkeypatch):
    """`loop.train` of `data.stream=true` in one process (it raised before
    the stream was ported): the batches it steps on are host_batch_iter's
    from the run's seed, and the loss stays finite."""
    seen = []
    real = loop.prefetch_to_device

    def recording(it, **kw):
        for b in real(it, **kw):
            seen.append({k: v.clone() for k, v in b.items()})
            yield b

    monkeypatch.setattr(loop, "prefetch_to_device", recording)
    cfg = load_config("blender_lego", OVR + [
        "data.stream=true", "train.iters=4", "train.log_every=2",
        "train.eval_every=4", "train.ckpt_every=100", "train.seed=7"])
    with torch.enable_grad():
        state, hist = loop.train(cfg, dataset_dict=scene,
                                 log_fn=lambda e: None, device="cpu")
    assert state.step == 4 and len(seen) >= 4
    ds = pipeline.RayDataset(scene["images"], scene["poses"],
                             scene["focal"])
    want = pipeline.host_batch_iter(ds.batch_arrays(), 64, seed=7)
    for got in seen[:4]:
        w = next(want)
        for k in w:
            np.testing.assert_array_equal(got[k].numpy(), w[k])
    assert all(np.isfinite(h["loss"]) for h in hist if "loss" in h)
    assert [h["step"] for h in hist if "val_psnr" in h] == [4]
