"""Training the garment matcher with the port on the CPU
(`tryon/matcher.py::train_matcher`) against the reference's
(`fashion_nerf.tryon.matcher.train_matcher` and its loop body), f32
throughout, the TPS solve included: the loss and gradients of one batch of
2 procedural pairs at 32×32; the parameters after 3 Adam steps of the same
seed stream; the init's shapes and variances against flax's; and the asset
round trip in the reference's layout. Reference results are module-scoped.

At the init the residual is zero (head1's kernel starts at zero), and the
keypoint-grid TPS maps rows of output pixels onto rows of source pixels,
where the bilinear sample's derivative jumps (its floor): f32 rounding of
the solve picks the side, so there the gradient (nonzero only in head1) is
held in its pattern, not its values (measured: 1.7× its RMS apart; a
nudge of 4e-5 px jumps it by 2.1×, the witness below). Values are held
from the reference's parameters after its own 3 steps from that init, off
the jump."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.tryon import matcher as jm
from fashion_nerf.tryon.pipeline import _preprocess_device as j_pre
from fashion_nerf.tryon.pipeline import \
    keypoint_grid_correspondences as j_kgc
from fashion_nerf_torch.tryon import matcher as tm

torch.set_num_threads(2)

HW, SEED0, STEPS, BATCH, LR = 32, 1, 3, 2, 3e-4
SEEDS = [11, 12]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _ref_init(key=jax.random.PRNGKey(0)):
    """The reference's init, as its train_matcher draws it."""
    probe = jm.make_batch([SEED0], HW, HW)
    pre0 = jm._device_pair({k: np.asarray(v[0]) for k, v in probe.items()},
                           HW, HW)
    person0, cloth0 = jm._pair_features(pre0, probe["cloth"][0],
                                        probe["cloth_mask"][0])
    return jax.device_get(jm.GarmentMatcher().init(key, person0, cloth0))


def _ref_loss_grad(params, arrs):
    """The reference train step's loss_fn (tryon/matcher.py:163-190) and
    its gradients, → (loss, grads)."""
    value, grads = _ref_value_and_grad()(params, arrs)
    return float(value), jax.device_get(grads)


@functools.lru_cache(maxsize=1)
def _ref_value_and_grad():
    """The jitted loss and gradient, built once (one compile for every
    batch of the same shape)."""
    module = jm.GarmentMatcher()

    def single(p, image, cloth, cloth_mask, parse, keypoints):
        pre = j_pre(image, cloth, cloth_mask, parse, keypoints, H=HW, W=HW)
        _, wm, dst = jm.matched_warp(p, module, pre, cloth, cloth_mask,
                                     keypoints, HW, HW)
        tgt = pre["garment_mask"]
        _, dst0 = j_kgc(cloth_mask, tgt, keypoints, HW, HW, k_rows=jm.K_ROWS)
        return 1.0 - jm.soft_iou(wm, tgt) + 0.01 * jnp.mean(
            (dst - dst0) ** 2)

    def loss(p, arrs):
        return jnp.mean(jax.vmap(lambda *a: single(p, *a))(
            *(arrs[k] for k in tm.PAIR_ARRAYS)))

    return jax.jit(jax.value_and_grad(loss))


def _ref_train(params, steps, seed0):
    """The reference's train_matcher loop body (tryon/matcher.py:192-207)
    from `params`: optax.adam(LR) on the batch mean, seeds drawn from
    np.random.default_rng(seed0) → (params, per-step losses)."""
    import optax
    tx = optax.adam(LR)
    opt = tx.init(params)
    rng = np.random.default_rng(seed0)
    losses = []
    for _ in range(steps):
        arrs = jm.make_batch(rng.integers(1, 1_000_000, BATCH).tolist(), HW,
                             HW)
        loss, grads = _ref_loss_grad(params, arrs)
        upd, opt = tx.update(grads, opt, params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, upd)
        losses.append(loss)
    return jax.device_get(params), losses


@pytest.fixture(scope="module")
def ref():
    init = _ref_init()
    trained, _, hist = jm.train_matcher(jax.random.PRNGKey(0), steps=STEPS,
                                        batch=BATCH, H=HW, W=HW, lr=LR,
                                        seed0=SEED0)
    trained = jax.device_get(trained)
    arrs = jm.make_batch(SEEDS, HW, HW)
    return dict(init=init, trained=trained, hist=hist,
                at_init=_ref_loss_grad(init, arrs),
                at_trained=_ref_loss_grad(trained, arrs),
                more=_ref_train(trained, STEPS, SEED0 + 1))


def _leaves(tree):
    return {(name, kind): np.asarray(v)
            for name, leaf in tree["params"].items()
            for kind, v in leaf.items()}


def _port_grads(m):
    """The port's gradients in the reference's layout."""
    out = {}
    for name, layer in m._named():
        g = layer.weight.grad
        out[name, "kernel"] = (g.permute(2, 3, 1, 0) if g.dim() == 4
                               else g.t()).numpy()
        out[name, "bias"] = layer.bias.grad.numpy()
    return out


@pytest.mark.parametrize("at", ["at_init", "at_trained"])
def test_batch_loss_and_gradients_match_reference(ref, at):
    """The batch loss 1e-4 relative and the gradients' zero pattern (at the
    init only head1's are nonzero, on both sides); after the reference's 3
    steps every gradient within 1e-3 relative RMS."""
    params = ref["init" if at == "at_init" else "trained"]
    m = tm.GarmentMatcher().load_flax(params)
    loss, iou = tm.batch_loss(m, tm.make_batch(SEEDS, HW, HW), HW, HW)
    loss.backward()
    loss, l_j = float(loss.detach()), ref[at][0]
    assert abs(loss - l_j) <= 1e-4 * abs(l_j), (loss, l_j)
    assert 0.0 < float(iou.detach()) < 1.0
    want, got = _leaves(ref[at][1]), _port_grads(m)
    nonzero = {k for k, w in want.items() if _rms(w) > 0}
    assert nonzero == {k for k, g in got.items() if _rms(g) > 0}
    if at == "at_init":
        assert nonzero == {("head1", "kernel"), ("head1", "bias")}
        return
    assert nonzero == set(want)
    for key, g in got.items():
        w = want[key]
        assert _rms(g - w) <= 1e-3 * _rms(w), (key, _rms(g - w) / _rms(w))


def test_init_gradient_sits_on_the_samples_kink(ref):
    """Why the init's gradients are held by their pattern only: nudging
    every target by 2.5e-6 (head1's bias ±1e-5, 4e-5 px) either way jumps
    head1's gradient by more than its RMS at the init (measured: 2.1×, the
    same at ±1e-4: a jump, not a slope), more than the port and the
    reference differ there (1.7×); after 3 steps the same nudge moves it by
    under 1e-3 of its RMS (measured: 8e-5, linear in the nudge)."""
    arrs = tm.make_batch(SEEDS, HW, HW)

    def head1_grads(params, nudge):
        m = tm.GarmentMatcher().load_flax(params)
        with torch.no_grad():
            m.head1.bias += nudge
        tm.batch_loss(m, arrs, HW, HW)[0].backward()
        return _port_grads(m)

    for at, params in (("at_init", ref["init"]), ("at_trained",
                                                  ref["trained"])):
        up, down = head1_grads(params, 1e-5), head1_grads(params, -1e-5)
        here, want = head1_grads(params, 0.0), _leaves(ref[at][1])
        for key in (("head1", "kernel"), ("head1", "bias")):
            scale, jump = _rms(want[key]), _rms(up[key] - down[key])
            if at == "at_init":
                assert jump >= max(scale, _rms(here[key] - want[key])), (
                    key, jump / scale)
            else:
                assert jump <= 1e-3 * scale, (key, jump / scale)


def test_train_matcher_matches_reference_loop(ref):
    """train_matcher against the reference's loop body, 3 Adam steps of the
    same seed stream from the reference's parameters after its own 3 steps
    (carried across with load_flax): the losses 1e-4 relative; every
    parameter's move within 1e-2·lr of the reference's on all but at most
    1% of each tensor's elements (one allowed in a tensor of fewer than 100,
    as tests/test_torch_train_tryon.py)."""
    start = ref["trained"]
    m = tm.GarmentMatcher().load_flax(start)
    m, hist = tm.train_matcher(steps=STEPS, batch=BATCH, H=HW, W=HW, lr=LR,
                               seed0=SEED0 + 1, matcher=m, device="cpu")
    want_p, want_l = ref["more"]
    assert len(hist) == STEPS
    for h, lj in zip(hist, want_l):
        assert abs(h["loss"] - lj) <= 1e-4 * abs(lj), (h, lj)
    got, want, init = (_leaves(m.to_flax()), _leaves(want_p),
                       _leaves(start))
    for key, w in want.items():
        off = np.abs((got[key] - init[key]) - (w - init[key])) > 1e-2 * LR
        assert off.sum() <= max(1, 1e-2 * off.size), (key, off.sum())
        assert np.abs(got[key] - init[key]).max() > 0.0, key


def test_train_matcher_without_cuda_raises(monkeypatch):
    """train_matcher runs on the card: without one it raises unless the
    CPU is asked for by name, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.train_matcher(steps=1, batch=1, H=HW, W=HW)


def test_init_flax_draws_as_flax():
    """init_flax_: every tensor of flax's init shape; kernels' variances
    within 10% of flax's draw (head1's kernel zero, as flax's), biases
    zero; a fresh matcher is the procedural baseline (zero residual)."""
    want = _leaves(_ref_init(jax.random.PRNGKey(5)))
    m = tm.GarmentMatcher().init_flax_(torch.Generator().manual_seed(5))
    got = _leaves(m.to_flax())
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    for key, w in want.items():
        g = got[key]
        if key[1] == "bias" or key == ("head1", "kernel"):
            assert not g.any() and not w.any(), key
        else:
            assert abs(g.var() / w.var() - 1.0) <= 0.1, (key, g.var(),
                                                          w.var())
    arrs = tm.make_batch([3], HW, HW)
    pre = tm._device_pair({k: v[0].numpy() for k, v in arrs.items()}, HW, HW)
    with torch.no_grad():
        res = m(*tm._pair_features(pre, arrs["cloth"][0],
                                   arrs["cloth_mask"][0]))
    assert res.shape == (tm.N_PTS, 2) and not res.any()


def test_save_matcher_round_trip(ref, tmp_path):
    """save_matcher writes the reference's asset layout: the port's
    load_matcher and the reference's load_matcher read it back to the same
    weights and the same residuals."""
    path = str(tmp_path / "matcher.npz")
    m = tm.GarmentMatcher().load_flax(ref["trained"])
    tm.save_matcher(m, path, meta={"iou_learned": 0.5})
    back = tm.load_matcher(path)
    for key, w in _leaves(ref["trained"]).items():
        np.testing.assert_array_equal(_leaves(back.to_flax())[key], w)
        np.testing.assert_array_equal(
            np.asarray(_leaves(jm.load_matcher(path))[key]), w)
    arrs = tm.make_batch([4], HW, HW)
    pre = tm._device_pair({k: v[0].numpy() for k, v in arrs.items()}, HW, HW)
    feats = tm._pair_features(pre, arrs["cloth"][0], arrs["cloth_mask"][0])
    with torch.no_grad():
        torch.testing.assert_close(back(*feats), m(*feats), rtol=0, atol=0)
