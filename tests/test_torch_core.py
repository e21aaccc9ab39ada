"""The port's core math (fashion_nerf_torch.core) against the JAX reference
on the same numpy inputs: cameras, posenc, eval-mode sampling, volume
rendering. All f32; tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.core import cameras as jcam
from fashion_nerf.core.posenc import posenc as j_posenc
from fashion_nerf.core import sampling as jsamp
from fashion_nerf.core import volrend as jvr
from fashion_nerf_torch.core import cameras, posenc, sampling, volrend

torch.set_num_threads(2)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.zeros((3, 4), np.float32)
    c2w[:, :3] = q
    c2w[:, 3] = rng.normal(size=3) * 3.0
    return c2w


def test_generate_rays():
    """f32 atol 1e-5: the rotation is a 3-term f32 sum on both sides."""
    c2w = _rot(np.random.default_rng(0))
    ro_j, rd_j = jcam.generate_rays(6, 8, 5.0, jnp.asarray(c2w))
    ro_t, rd_t = cameras.generate_rays(6, 8, 5.0, c2w)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-5)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-5)


def test_ndc_rays():
    """NDC reaches |coords| ~ 10 on grazing rays: f32 rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(1)
    ro = rng.normal(size=(32, 3)).astype(np.float32)
    rd = rng.normal(size=(32, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    oj, dj = jcam.ndc_rays(20, 30, 25.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    ot, dt = cameras.ndc_rays(20, 30, 25.0, 1.0, torch.from_numpy(ro),
                              torch.from_numpy(rd))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("L", [4, 10])
def test_posenc(L):
    """f32 atol 1e-5: same products 2^k·x, sin/cos to ~1 ulp."""
    x = np.random.default_rng(2).uniform(-1.5, 1.5, (5, 7, 3)).astype(
        np.float32)
    np.testing.assert_allclose(posenc.posenc(torch.from_numpy(x), L).numpy(),
                               np.asarray(j_posenc(jnp.asarray(x), L)),
                               atol=1e-5)


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_sample_det(per_ray, lindisp):
    """Eval-mode linspace; f32 atol 1e-5 (linspace may differ by 1 ulp)."""
    rng = np.random.default_rng(3)
    R, S = 16, 64
    near, far = 2.0, 6.0
    if per_ray:
        near = rng.uniform(2.0, 3.0, R).astype(np.float32)
        far = rng.uniform(4.0, 6.0, R).astype(np.float32)
    tj = jsamp.stratified_sample(None, jnp.asarray(near), jnp.asarray(far),
                                 R, S, perturb=False, lindisp=lindisp)
    tt = sampling.stratified_sample(torch.as_tensor(near),
                                    torch.as_tensor(far), R, S,
                                    lindisp=lindisp)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


def test_sample_pdf_det():
    """Det inverse CDF, atol 1e-4 (the quantile linspace may differ by an
    ulp, amplified by bin width / bin mass). Rows cover: random mass, an
    all-zero row (the eps floor makes it uniform), a row whose last
    quantile u = 1 lands on or past cdf[-1] (clamped to the last edge), a
    degenerate row of equal edges (a missed ray), and edge-bin layouts."""
    rng = np.random.default_rng(4)
    R, B, N = 8, 64, 96
    t = np.sort(rng.uniform(2.0, 6.0, (R, B + 1)), axis=1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (R, B)).astype(np.float32) ** 4
    w[1] = 0.0                          # all-zero mass
    w[2, :] = 1e-8
    w[2, -1] = 1.0                      # nearly all mass in the last bin
    t[3] = 6.0                          # degenerate: all edges equal
    w[4, :-1] = 0.0                     # mass only at the end
    sj = jsamp.sample_pdf(None, jnp.asarray(t), jnp.asarray(w), N, det=True)
    st = sampling.sample_pdf(torch.from_numpy(t), torch.from_numpy(w), N)
    wt = torch.from_numpy(w) + 1e-5
    cdf_last = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)[:, -1]
    assert bool((cdf_last <= 1.0).any())   # u = 1 ≥ cdf[-1]: the clamp runs
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    assert np.all(st.numpy()[:, -1] <= t[:, -1] + 1e-6)
    np.testing.assert_array_equal(st.numpy()[3], 6.0)


@pytest.mark.parametrize("t_end", [None, 6.0])
@pytest.mark.parametrize("white", [False, True])
def test_volume_render(t_end, white):
    """f32 atol 1e-5 on every output (same cumprod order on both sides)."""
    rng = np.random.default_rng(5)
    R, S = 16, 48
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    sigma = rng.normal(0, 3, (R, S)).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 5.9, (R, S)), axis=1).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    oj = jvr.volume_render(jnp.asarray(rgb), jnp.asarray(sigma),
                           jnp.asarray(t), jnp.asarray(rd), white_bkgd=white,
                           t_end=t_end)
    ot = volrend.volume_render(torch.from_numpy(rgb), torch.from_numpy(sigma),
                               torch.from_numpy(t), torch.from_numpy(rd),
                               white_bkgd=white, t_end=t_end)
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   atol=1e-5, err_msg=k)
