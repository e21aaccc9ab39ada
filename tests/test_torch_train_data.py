"""The port's training data and random draws against the reference's:
the hermetic scenes bitwise, the device-resident rays and the precrop
switch, and the distributions of the jittered stratified samples and of
the random-quantile inverse CDF (the port draws from torch generators, the
reference from JAX keys, so the draws are compared as distributions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.core import sampling as jsamp
from fashion_nerf.data import synthetic as jsyn
from fashion_nerf.data.pipeline import RayDataset as JRayDataset
from fashion_nerf.data.tiny import load_tiny as j_load_tiny
from fashion_nerf_torch.core import sampling
from fashion_nerf_torch.data import synthetic
from fashion_nerf_torch.data.pipeline import RayDataset, sample_batch
from fashion_nerf_torch.data.tiny import load_tiny

torch.set_num_threads(2)

KS_MAX = 0.03    # two-sample KS statistic, n = 16384 each (p < 1e-3: 0.022)


def _ks(a, b):
    a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, side="right") / a.size
                        - np.searchsorted(b, grid, side="right") / b.size
                        ).max())


@pytest.mark.parametrize("kw", [
    dict(n_views=2, H=16, W=16),
    dict(n_views=2, H=16, W=16, scale=0.5, sharp=80.0, texture=0.6)])
def test_synthetic_scene_bitwise(kw):
    a = synthetic.make_synthetic_scene(**kw)
    b = jsyn.make_synthetic_scene(**kw)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


def test_forward_scene_and_tiny_bitwise():
    a = synthetic.make_forward_scene(n_views=2, H=12, W=16)
    b = jsyn.make_forward_scene(n_views=2, H=12, W=16)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)
    t = load_tiny("", n_views=2, H=16, W=16)
    tj = j_load_tiny("", n_views=2, H=16, W=16)
    for k in tj:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(tj[k]), k)


@pytest.mark.parametrize("ndc", [False, True])
def test_ray_dataset_matches_reference(ndc):
    s = synthetic.make_synthetic_scene(n_views=3, H=12, W=16)
    ours = RayDataset(s["images"], s["poses"], s["focal"], ndc=ndc,
                      precrop_frac=0.5)
    ref = JRayDataset(s["images"], s["poses"], s["focal"], ndc=ndc,
                      precrop_frac=0.5)
    for k, v in ref.batch_arrays().items():
        np.testing.assert_allclose(ours.batch_arrays()[k].numpy(),
                                   np.asarray(v), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(ours.crop_idx.numpy(),
                                  np.asarray(ref.crop_idx))
    assert ours.n_rays == ref.n_rays == 3 * 12 * 16


def test_sample_batch_precrop_switch():
    s = synthetic.make_synthetic_scene(n_views=2, H=16, W=16)
    ds = RayDataset(s["images"], s["poses"], s["focal"])
    rays = ds.batch_arrays()
    crop = set(ds.crop_idx.tolist())
    g = torch.Generator().manual_seed(0)

    def ids(step):
        b = sample_batch(rays, g, 512, ds.n_rays, crop_idx=ds.crop_idx,
                         step=step, precrop_iters=10)
        return set(b["frame_ids"].tolist()), b

    def in_crop(b):
        # a ray is in the crop iff its origin+direction pair is a crop ray
        key = torch.cat([b["rays_d"], b["frame_ids"][:, None].float()], 1)
        ref = torch.cat([rays["rays_d"], rays["frame_ids"][:, None].float()],
                        1)[ds.crop_idx]
        return (key[:, None, :] == ref[None]).all(-1).any(1)

    for step, want in ((None, True), (0, True), (9, True), (10, False)):
        _, b = ids(step)
        inside = in_crop(b)
        assert bool(inside.all()) == want, step
    assert len(crop) == 2 * 8 * 8


def test_jittered_stratified_distribution():
    """One uniform draw per bin: every sample inside its bin, and the
    position within the bin distributed as the reference's."""
    R, S, near, far = 256, 64, 2.0, 6.0
    g = torch.Generator().manual_seed(0)
    t = sampling.stratified_sample(near, far, R, S, perturb=True,
                                   generator=g).numpy()
    tj = np.asarray(jsamp.stratified_sample(jax.random.PRNGKey(0), near, far,
                                            R, S, perturb=True))
    z = np.linspace(near, far, S, dtype=np.float32)
    mids = 0.5 * (z[1:] + z[:-1])
    lo = np.concatenate([z[:1], mids])
    hi = np.concatenate([mids, z[-1:]])
    assert np.all((t >= lo - 1e-6) & (t <= hi + 1e-6))
    u, uj = (t - lo) / (hi - lo), (tj - lo) / (hi - lo)
    assert _ks(u, uj) <= KS_MAX
    assert abs(u.mean() - 0.5) < 0.01
    det = sampling.stratified_sample(near, far, R, S).numpy()
    np.testing.assert_allclose(det[0], z, atol=1e-6)


def test_random_sample_pdf_distribution():
    """Random quantiles: the samples follow the piecewise-constant PDF, as
    the reference's do; explicit quantiles give the reference's samples."""
    B, R, N = 8, 256, 64
    bins = np.linspace(2.0, 6.0, B + 1, dtype=np.float32)
    w = np.array([0.1, 2.0, 0.3, 0.0, 4.0, 1.0, 0.2, 0.6], np.float32)
    bins_r = np.broadcast_to(bins, (R, B + 1)).copy()
    w_r = np.broadcast_to(w, (R, B)).copy()
    g = torch.Generator().manual_seed(0)
    s = sampling.sample_pdf(torch.from_numpy(bins_r), torch.from_numpy(w_r),
                            N, det=False, generator=g).numpy()
    sj = np.asarray(jsamp.sample_pdf(jax.random.PRNGKey(0),
                                     jnp.asarray(bins_r), jnp.asarray(w_r),
                                     N, det=False))
    assert _ks(s, sj) <= KS_MAX
    p = (w + 1e-5) / (w + 1e-5).sum()
    hist = np.histogram(s, bins=bins)[0] / s.size
    np.testing.assert_allclose(hist, p, atol=0.01)
    q = np.random.default_rng(1).uniform(size=(R, N)).astype(np.float32)
    sq = sampling.sample_pdf(torch.from_numpy(bins_r), torch.from_numpy(w_r),
                             N, quantiles=torch.from_numpy(q)).numpy()
    sqj = np.asarray(jsamp.sample_pdf(None, jnp.asarray(bins_r),
                                      jnp.asarray(w_r), N,
                                      quantiles=jnp.asarray(q)))
    np.testing.assert_allclose(sq, sqj, atol=1e-4)


def test_init_field_distribution():
    """LeCun-normal kernels (truncated at ±2σ, variance 1/fan_in) and zero
    biases, as flax's Dense initialises the reference's fields."""
    from fashion_nerf.config import load_config
    from fashion_nerf.models.nerf_mlp import init_field as j_init
    from fashion_nerf_torch.models.nerf_mlp import init_field
    mcfg = load_config("blender_lego").model
    ours = init_field(mcfg, torch.Generator().manual_seed(0))
    ref = jax.device_get(j_init(jax.random.PRNGKey(0), mcfg))["params"]
    for name, layer in ours.named_dense():
        w = layer.weight.detach().numpy().T
        wj = np.asarray(ref[name]["kernel"])
        assert w.shape == wj.shape, name
        assert np.all(layer.bias.detach().numpy() == 0.0), name
        assert w.dtype == np.float32
        fan_in = w.shape[0]
        if w.size >= 4096:
            assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.05, name
            assert _ks(w * np.sqrt(fan_in), wj * np.sqrt(fan_in)) <= 0.05
        bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= bound * (1 + 1e-6), name


def test_ssim_and_psnr_match_reference():
    from fashion_nerf import metrics as jm
    from fashion_nerf_torch import metrics
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.ssim(ta, tb)),
                               float(jm.ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jm.psnr(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-4)
    np.testing.assert_allclose(float(metrics.mse_to_psnr(torch.tensor(0.01))),
                               20.0, atol=1e-5)


def test_generator_chain_single_use():
    from fashion_nerf_torch.prng import GeneratorChain, GeneratorReuseError
    a, b = GeneratorChain(3), GeneratorChain(3)
    ga, gb = a.once("init"), b.once("init")
    assert torch.equal(torch.rand(4, generator=ga), torch.rand(4, generator=gb))
    assert not torch.equal(torch.rand(4, generator=a.once("run")),
                           torch.rand(4, generator=a.once("other")))
    with pytest.raises(GeneratorReuseError):
        a.once("init")
    a.freeze()
    with pytest.raises(GeneratorReuseError):
        a.once("fresh")
