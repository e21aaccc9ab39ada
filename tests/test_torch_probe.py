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
    if mode in ("chain", "hold"):     # chain_f32_hold is chain_relu's math
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
                                       ("hold", True), ("streams", True),
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


def test_pack_probe_weights_matches_wgpack_tiling():
    """The kernel's weight stream: per layer and 256-column block, the
    64-row K slices in order, each tiled as kernels/wgpack.py tiles a
    slice."""
    from fashion_nerf_torch.kernels import wgpack
    D, W = 3, 512
    ws = torch.tensor(np.random.default_rng(0).normal(size=(D, W, W)),
                      dtype=torch.bfloat16)
    wp = probe.pack_probe_weights(ws)
    want = [wgpack._tile(ws[k, ks * 64:(ks + 1) * 64,
                            cp * 256:(cp + 1) * 256])
            for k in range(D) for cp in range(W // 256)
            for ks in range(W // 64)]
    assert torch.equal(wp, torch.cat(want))


@pytest.mark.parametrize("mode,width,depth,relu,launches", [
    ("chain", 192, 3, True, 1), ("streams", 64, 5, True, 1),
    ("dependent", 272, 3, False, 1), ("independent", 1008, 2, False, 1),
    ("streams", 512, 5, True, 2), ("chain", 768, 3, True, 4),
    ("dependent", 1024, 2, False, 2), ("streams", 528, 4, True, 6),
    ("hold", 128, 3, True, 1)])
def test_wrapper_pads_and_composes(monkeypatch, mode, width, depth, relu,
                                   launches):
    """The CUDA path of `tc_chain` with the kernel's launch replaced by
    the plain chain on the padded operands: widths that are no multiple of
    256 are zero-padded and cut back, and shapes one launch does not take
    (a chain over 512 wide, two streams over 256) are composed of
    launches; the result equals the plain chain on the unpadded inputs up
    to summation order: the CPU's BLAS blocks a padded product differently,
    which can flip an activation by one bf16 ulp, so the whole is held to
    1e-3 relative RMS and every element to the probe's 2e-2 of the largest
    output."""
    rng = np.random.default_rng(width + depth)
    x = torch.tensor(rng.normal(size=(64, width)), dtype=torch.bfloat16)
    ws = torch.tensor(0.06 * rng.normal(size=(depth, width, width)),
                      dtype=torch.bfloat16)
    seen = []

    def launch(xp, wsp, m, r, counter):
        assert xp.shape[1] % 256 == 0 and probe.single_launch(
            m, xp.shape[1], wsp.shape[0])
        assert wsp.shape[1:] == (xp.shape[1], xp.shape[1])
        assert probe.pack_probe_weights(wsp).numel() == wsp.numel()
        seen.append(counter)
        return probe.tc_chain_plain(xp, wsp, m, r)

    monkeypatch.setattr(K, "on_cuda", lambda *a: True)
    monkeypatch.setattr(probe, "_launch", launch)
    got = probe.tc_chain(x, ws, mode, relu)
    want = probe.tc_chain_plain(x, ws, mode, relu)
    assert got.shape == want.shape and got.is_contiguous()
    assert len(seen) == launches and set(seen) == {probe._COUNTER[mode]}
    assert float((got - want).norm()) <= 1e-3 * float(want.norm())
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_reference_rows_and_flop_counts():
    """Every row of mfu_probe.py is reported: P1's four variants, each its
    own launch (`chain f32hold` is the kernel's hold mode), and P2's six
    shapes, with the schedule-only `il=1` row named as the same launch as
    its sibling, and the reference's FLOP counts."""
    assert [v[0] for v in probe.P1_VARIANTS] == [
        "chain", "chain+relu", "chain f32hold", "2 streams"]
    assert [s[0] for s in probe.P2_SHAPES] == [
        "w256 d9 dependent", "w256 d9 independent", "w512 d9 dependent",
        "w512 d9 independent", "w256 d9 dep il=1 (M=2048)",
        "w1024 d4 independent"]
    seen = []
    rows = probe.run_p1(torch.device("cpu"), n=64, iters=1,
                        log=seen.append)
    assert [r["same_as"] for r in rows] == [None, None, None, None]
    assert [v[1] for v in probe.P1_VARIANTS] == ["chain", "chain", "hold",
                                                 "streams"]
    assert all(r["ms"] > 0 and r["tflops"] > 0 for r in rows)
    rows = probe.run_p2(torch.device("cpu"), n=64, iters=1,
                        log=seen.append)
    assert rows[4]["same_as"] == "w256 d9 dependent"
    assert "same launch as w256 d9 dependent" in seen[4 + 4]
    # 2·W²·(depth+1) per row for P1, 2·W²·depth for P2
    r = rows[5]
    assert r["tflops"] == pytest.approx(64 * 2 * 1024 * 1024 * 4
                                        / (r["ms"] * 1e-3) / 1e12)


def test_probe_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])
    assert probe.main(["--device", "cpu", "--rows", "64", "--shapes"]) == 0
