"""The bench's choice of what it renders (`bench.bench_setup`, the
reference's `_bench_params` and `run_bench` setup), on the CPU: the
committed weights only for the config they were trained for, with
occupancy and the committed proposal; random init, no occupancy and no
proposal otherwise (llff_fern, whose tree matches but which lives in NDC
space; the presets whose trees differ). The trained flag agrees with the
reference's for every preset."""

import pytest
import torch

from fashion_nerf.bench import _bench_params as j_bench_params
from fashion_nerf.bench import bench_train as j_bench_train
from fashion_nerf.config import PRESETS as J_PRESETS
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf_torch import bench
from fashion_nerf_torch.assets import load_flagship
from fashion_nerf_torch.config import load_config

torch.set_num_threads(2)


def test_llff_fern_takes_random_init_without_occupancy():
    s = bench.bench_setup(load_config("llff_fern"), "cpu")
    assert s["trained"] is False and s["occ"] is None
    assert sorted(s["params"]) == ["coarse", "fine"]     # no proposal
    assert s["blockwise"] is True and s["cond"] is None
    again = bench.bench_params(load_config("llff_fern"), "cpu")[0]
    for k in ("coarse", "fine"):                         # seeded
        for a, b in zip(s["params"][k].parameters(),
                        again[k].parameters()):
            assert torch.equal(a, b)
    trained = load_flagship()[0]
    w = s["params"]["fine"].to_flax_params()["params"]["trunk_0"]["kernel"]
    assert w.shape == trained["fine"]["params"]["trunk_0"]["kernel"].shape
    assert (w != trained["fine"]["params"]["trunk_0"]["kernel"]).any()


def test_blender_lego_keeps_its_choice():
    """The committed weights, the occupancy sweep and the committed
    proposal (a 16³ sweep here, to keep the CPU run short)."""
    if load_flagship() is None:
        pytest.skip("trained flagship asset missing")
    s = bench.bench_setup(load_config("blender_lego",
                                      ["occupancy.resolution=16"]), "cpu")
    assert s["trained"] is True and s["occ"] is not None
    assert sorted(s["params"]) == ["coarse", "fine", "proposal"]
    assert bool(s["occ"].boxes_occ.any())


@pytest.mark.parametrize("name", sorted(J_PRESETS))
def test_trained_flag_matches_reference(name):
    want = j_bench_params(j_load_config(name))[1]
    got = bench.bench_params(load_config(name), "cpu")[1]
    assert got is want


def test_bench_train_keys_match_reference():
    """`bench_train` on the CPU: the reference's keys (its bench_train on
    the same config, one warm-up step and one timed), value = batch rays / step seconds, and the
    device's name and power limit beside them."""
    got = bench.bench_train(load_config("tiny_lego"), steps=2, warmup=1,
                            device="cpu")
    want = j_bench_train(j_load_config("tiny_lego"), steps=1, warmup=1)
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"device", "power_limit"}
    assert got["device"] == "cpu" and got["power_limit"] is None
    assert (got["metric"], got["unit"], got["config"]) == (
        want["metric"], want["unit"], want["config"])
    batch = load_config("tiny_lego").train.batch_rays
    # value is rounded to 0.1 rays/s and step_ms to 1 µs: half a unit of
    # the first, and half a µs of the second carried through batch / s
    # (d value = value · d step_ms / step_ms)
    tol = 0.05 + got["value"] * 5e-4 / got["step_ms"]
    assert got["value"] == pytest.approx(batch / (got["step_ms"] / 1e3),
                                         rel=0, abs=tol)


def test_bench_main_train_prints_one_line(monkeypatch, capsys):
    """`python -m fashion_nerf_torch.bench --train` prints bench_train's
    JSON line; without --train the render bench's; without CUDA and
    without --device cpu it raises."""
    import json
    real = bench.bench_train
    seen = {}

    def fake_train(cfg, device=None):
        seen["train"] = (cfg.name, device)
        return {"metric": "m", "value": 1.0}

    monkeypatch.setattr(bench, "bench_train", fake_train)
    monkeypatch.setattr(bench, "run_bench", lambda cfg: {"render": cfg.name})
    bench.main(["--train", "--config", "tiny_lego", "--device", "cpu"])
    bench.main(["--config", "tiny_lego"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in lines] == [
        {"metric": "m", "value": 1.0}, {"render": "tiny_lego"}]
    assert seen["train"] == ("tiny_lego", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        real(load_config("tiny_lego"), steps=1, warmup=0)
