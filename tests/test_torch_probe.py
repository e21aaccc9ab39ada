"""The tensor-core probe's plain chains (fashion_nerf_torch.probe) against
the same chains in jnp, written as scripts/mfu_probe.py's bodies write them
(`jnp.dot(..., preferred_element_type=f32).astype(bf16)`), at 256 rows ×
widths 64 and 256 × depth 3, on the same bf16 inputs from a numpy seed.

Bound: the two sum the same bf16 products in f32 in different orders, so
an activation can round to the neighbouring bf16 value (a 1-ulp flip) and
carry that into the next layer. Each output element is held to one bf16
ulp (2^-8 relative, plus 1e-6 absolute) on all but 1% of the elements, and
the whole to 1e-2 relative RMS (measured here: at most 0.16% of the
elements over the ulp and 1.2e-4 relative RMS, both at width 256)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch import probe

torch.set_num_threads(2)

ROWS, DEPTH = 256, 3


def _dot(a, b):
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


def _jnp_chain(x, ws, mode, relu):
    """mfu_probe.py's chain / chain_relu / chain2 (main) and bench's
    dependent and independent bodies (shape_sweep), at any depth."""
    bf = jnp.bfloat16
    if mode == "chain":
        h = x
        for w in ws:
            v = _dot(h, w)
            h = (jnp.maximum(v, 0.0) if relu else v).astype(bf)
        return _dot(h, ws[0])
    if mode == "streams":
        h1, h2 = x, x
        for k in range(0, len(ws) - 1, 2):
            h1 = jnp.maximum(_dot(h1, ws[k]), 0.0).astype(bf)
            h2 = jnp.maximum(_dot(h2, ws[k + 1]), 0.0).astype(bf)
        return _dot(h1, ws[0]) + _dot(h2, ws[1])
    if mode == "dependent":
        h = x
        for w in ws:
            h = _dot(h, w).astype(bf)
        return h.astype(jnp.float32)
    acc = jnp.zeros((x.shape[0], x.shape[1]), jnp.float32)
    for w in ws:
        acc += _dot(x, w)
    return acc


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("mode,relu", [("chain", False), ("chain", True),
                                       ("streams", True),
                                       ("dependent", False),
                                       ("independent", False)])
def test_plain_chain_matches_jnp(width, mode, relu):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(ROWS, width)).astype(np.float32)
    ws = (0.06 * rng.normal(size=(DEPTH, width, width))).astype(np.float32)
    x_t, ws_t = (torch.tensor(a).to(torch.bfloat16) for a in (x, ws))
    want = np.asarray(_jnp_chain(jnp.asarray(x, jnp.bfloat16),
                                 list(jnp.asarray(ws, jnp.bfloat16)), mode,
                                 relu))
    K.reset_launches()
    got = probe.tc_chain(x_t, ws_t, mode, relu).numpy()
    assert K.LAUNCHES["probe_p1"] == K.LAUNCHES["probe_p2"] == 0
    assert got.shape == (ROWS, width) and got.dtype == np.float32
    err = np.abs(got - want)
    over = err > 2.0 ** -8 * np.abs(want) + 1e-6
    assert over.mean() <= 1e-2, over.mean()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_reference_rows_and_flop_counts():
    """Every row of mfu_probe.py is reported: P1's four variants and P2's
    six shapes, with the two schedule-only rows named as the same launch
    as their siblings, and the reference's FLOP counts."""
    assert [v[0] for v in probe.P1_VARIANTS] == [
        "chain", "chain+relu", "chain f32hold", "2 streams"]
    assert [s[0] for s in probe.P2_SHAPES] == [
        "w256 d9 dependent", "w256 d9 independent", "w512 d9 dependent",
        "w512 d9 independent", "w256 d9 dep il=1 (M=2048)",
        "w1024 d4 independent"]
    seen = []
    rows = probe.run_p1(torch.device("cpu"), n=64, iters=1,
                        log=seen.append)
    assert [r["same_as"] for r in rows] == [None, None, "chain+relu", None]
    assert all(r["ms"] > 0 and r["tflops"] > 0 for r in rows)
    assert "same launch as chain+relu" in seen[2]
    rows = probe.run_p2(torch.device("cpu"), n=64, iters=1,
                        log=seen.append)
    assert rows[4]["same_as"] == "w256 d9 dependent"
    # 2·W²·(depth+1) per row for P1, 2·W²·depth for P2
    r = rows[5]
    assert r["tflops"] == pytest.approx(64 * 2 * 1024 * 1024 * 4
                                        / (r["ms"] * 1e-3) / 1e12)


def test_probe_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])
    assert probe.main(["--device", "cpu", "--rows", "64", "--shapes"]) == 0
