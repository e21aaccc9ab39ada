"""The operation counts against a hand count, and the metric readers on
records made by hand."""

import pytest

from perfbench import harness, roofline, weights
from perfbench.devtrace import DeviceTrace


def tree(model):
    return {"params": {name: {"kernel": [[0.0] * c] * r, "bias": [0.0] * c}
                       for name, r, c in weights.layer_shapes(model)}}


FIELD = {"net_depth": 8, "net_width": 256, "skips": [4], "posenc_xyz": 10,
         "posenc_dir": 4, "use_viewdirs": True}
PROPOSAL = {"net_depth": 2, "net_width": 128, "skips": [], "posenc_xyz": 6,
            "posenc_dir": 4, "use_viewdirs": False}


def test_field_hand_count():
    hand = (63 * 256 + 4 * 256 * 256 + (63 + 256) * 256 + 2 * 256 * 256
            + 256 + 256 * 256 + (256 + 27) * 128 + 128 * 3)
    assert hand == 593_408
    assert roofline.eval_macs(tree(FIELD)) == hand
    assert roofline.eval_flops(tree(FIELD)) == 1_186_816


def test_proposal_hand_count():
    assert roofline.eval_macs(tree(PROPOSAL)) == 39 * 128 + 128 * 128 + 128


def test_bound_takes_the_larger():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.share(0.5, 1.0) == pytest.approx(50.0)
    assert roofline.share(0.5, 0.0) is None


def record():
    rec = harness.Record(setup_s=12.5, window_s=2.0,
                         unit_s=[0.2] * 9 + [0.4], unit_work=[100] * 10)
    rec.trace = DeviceTrace(window_s=2.0, busy_s=1.5, ops={
        "void fnt::(anonymous namespace)::slim_march_kernel<256>": 0.5,
        "void fnt::(anonymous namespace)::sigma_march_kernel<128>": 0.1,
        "void fnt::(anonymous namespace)::field_kernel<256, true>": 0.3,
        "void at::native::vectorized_elementwise_kernel<4>": 0.4,
        "Memcpy DtoH (Device -> Pinned)": 0.2})
    rec.counts = [{"alive": 10, "alive_fine": 8, "coarse_needed": 640,
                   "fine_needed": 500}] * 10
    rec.flops = {"proposal": 43_008, "fine": 1_186_816}
    rec.budget = (64, 96)
    return rec


def test_readers():
    rec = record()
    assert harness.reader("render_rays_per_s")(rec) == pytest.approx(500.0)
    assert harness.reader("setup_s")(rec) == 12.5
    assert harness.reader("device_idle.render")(rec) == pytest.approx(25.0)
    assert harness.reader("glue_ms.frame")(rec) == pytest.approx(60.0)
    need = 10 * (10 * 64 * 43_008 + 8 * 96 * 1_186_816)
    assert harness.reader("mfu.render")(rec) == pytest.approx(
        100 * need / (2.0 * 989e12))
    flops = 10 * (640 * 43_008 + 500 * 1_186_816)
    assert harness.reader("march_roofline")(rec) == pytest.approx(
        100 * (flops / 989e12) / 0.6)
    assert harness.reader("field_roofline.render")(rec) == pytest.approx(
        100 * (flops / 989e12) / 0.3)


def test_readers_say_nothing_without_a_trace():
    rec = record()
    rec.trace = None
    for m in ("device_idle.render", "mfu.render", "march_roofline",
              "field_roofline.render", "glue_ms.frame"):
        assert harness.reader(m)(rec) is None
