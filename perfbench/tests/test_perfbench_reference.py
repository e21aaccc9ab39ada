"""The plain reference against the port's plain CPU path, piece by piece
and on tiny frames of each cell through the whole harness."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import nerf as ref

TINY = {"frame": [32, 32], "warm_frames": 1, "check_frames": 2}
SEED = 2 ** 31 + 977


def lego():
    return harness.Cell.load("lego.render.orbit")


def test_mlp_matches_the_port_in_f32():
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    cfg = lego().config
    trees = weights.cell_trees(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((512, 3), generator=g) * 2 - 1
    d = torch.randn((512, 3), generator=g)
    for name, tree in trees.items():
        port = load_flax_params(tree)          # float32
        rgb_p, sig_p = port.field(x[:, None], d)
        rgb_r, sig_r = ref.MLP(tree, "cpu")(x, d)
        assert torch.allclose(sig_r, sig_p[:, 0], rtol=1e-4, atol=1e-4), name
        if name != "proposal":
            assert torch.allclose(rgb_r, rgb_p[:, 0], atol=1e-5), name


def test_rays_ndc_and_block_order_match_the_port():
    from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays
    from fashion_nerf_torch.render.blockwise import _tile_order
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    o, d = generate_rays(24, 40, 30.0, c2w)
    ro, rd = ref.camera_rays(24, 40, 30.0, c2w, "cpu")
    assert torch.equal(ro, o.reshape(-1, 3)) and torch.equal(
        rd, d.reshape(-1, 3))
    no, nd = ndc_rays(24, 40, 30.0, 1.0, o.reshape(-1, 3), d.reshape(-1, 3))
    ro, rd = ref.to_ndc(24, 40, 30.0, 1.0, ro, rd)
    assert torch.allclose(ro, no, atol=1e-6) and torch.allclose(rd, nd,
                                                                atol=1e-6)
    order, inv = _tile_order(24, 40)
    r_order, r_inv = ref.block_order(24, 40)
    assert (order == r_order).all() and (inv == r_inv).all()


def test_occupancy_matches_the_port_on_the_same_field():
    from fashion_nerf_torch.core.occupancy import (build_from_config,
                                                   ray_multi_aabb)
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    doc = lego().config
    ocfg = dict(doc["config"]["occupancy"], resolution=32)
    cfg = load_config("blender_lego", ["occupancy.resolution=32"])
    fine = weights.cell_trees(doc, 0, "cpu")["fine"]
    port = load_flax_params(fine)
    occ_p = build_from_config(cfg, lambda p, v: port.field(p, v))
    mlp = ref.MLP(fine, "cpu")
    dirs = torch.tensor([[0.0, 0.0, -1.0]])
    occ_r = ref.occupancy(lambda p: mlp(p, dirs.expand(p.shape[0], 3))[1],
                          ocfg, "cpu")
    assert torch.equal(occ_p.box_min, occ_r["box_min"])
    assert torch.equal(occ_p.box_max, occ_r["box_max"])
    assert torch.equal(occ_p.grid, occ_r["grid"])
    assert torch.equal(occ_p.boxes_occ, occ_r["boxes_occ"])
    assert torch.equal(occ_p.boxes_min, occ_r["boxes_min"])
    assert torch.equal(occ_p.boxes_max, occ_r["boxes_max"])
    g = torch.Generator().manual_seed(2)
    o = torch.randn((256, 3), generator=g) * 3
    d = -o + torch.randn((256, 3), generator=g)
    got = ray_multi_aabb(o, d, occ_p, 2.0, 6.0)
    want = ref.box_segments(o, d, occ_r, 2.0, 6.0)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


def test_inverse_cdf_matches_the_port():
    from fashion_nerf_torch.core.sampling import sample_pdf
    g = torch.Generator().manual_seed(3)
    bins = torch.sort(torch.rand((64, 33), generator=g), dim=1).values
    w = torch.rand((64, 32), generator=g)
    assert torch.equal(sample_pdf(bins, w, 48), ref.inverse_cdf(bins, w, 48))


@pytest.mark.parametrize("workload", ["lego.render.orbit",
                                      "fern.render.frame"])
def test_tiny_frames_through_the_harness_are_correct(workload):
    cell = harness.Cell.load(workload)
    numbers = {}
    r = harness.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), 0.0,
                         traffic_overrides=TINY, numbers_out=numbers)
    assert r["correct"], numbers
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) for m in r["metrics"].values())


def test_control_fails_on_tiny_frames():
    from perfbench.calibrate import control_numbers
    for workload in ("lego.render.orbit", "fern.render.frame"):
        cell = harness.Cell.load(workload)
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **TINY))
        for seed in (5, 6, 7):
            got = control_numbers(cell, seed, torch.device("cpu"))
            assert any(got[k] > v for k, v in cell.limits.items()), (
                workload, seed, got)


@pytest.mark.parametrize("config,traffic,scene", [
    ("blender_lego", "steady16k",
     {"kind": "spheres", "n_views": 2, "H": 16, "W": 16, "seed": 0,
      "scale": 0.5, "sharp": 80.0, "texture": 0.6}),
    ("llff_fern", "dense16k",
     {"kind": "forward", "n_views": 3, "H": 24, "W": 32, "scale": 1.0,
      "sharp": 25.0, "texture": 0.0})])
def test_training_reference_follows_the_ports_float32_steps(config, traffic,
                                                            scene):
    """The reference's three steps (culled, culled and dense from the
    flagship's warm start; dense with σ noise in NDC for fern) against the
    port's steps on its float32 field: the same draws and the same
    algorithm, to float32 rounding."""
    cell = harness.Cell(
        name=traffic, chips=1,
        config=harness.load_json(f"perfbench/configs/{config}.json"),
        traffic=harness.load_json(f"perfbench/traffic/{traffic}.json"),
        end_to_end=[], per_layer=[], limits={})
    f32 = {"train.batch_rays": 1024, "kernels.fused_mlp": False,
           "model.compute_dtype": "float32", "occupancy.resolution": 16}
    numbers = {}
    harness.run_cell(cell, SEED, 0.1, False, torch.device("cpu"), 0.0,
                     traffic_overrides={"scene": scene, "overrides": f32},
                     numbers_out=numbers)
    assert max(numbers.values()) < 1e-4, numbers
