"""The spec sweep of the port (`quality.run_sweep`) against the reference's
(`scripts/quality_check.py` without `--gate`), on the CPU.

- SPECS is the reference's row list, names and keyword sets alike, read
  from scripts/quality_check.py with `ast` (the script is not run).
- Every row reaches only march shapes the kernels take: each row is
  rendered at 8×8 through the plain versions with every march wrapper's
  shape check called on what it is handed (the checks the card runs
  before a launch), so a row the card would refuse fails here.
- Four rows at 16×16 (occupancy at 32³, 20 distillation steps of 256
  points) against the same rows rendered by the reference's library:
  `render_image` on CPU XLA for the dense and culled rows,
  `render_image_blockwise` in interpret mode for a blockwise carry row
  and a proposal cov16 row, the latter with the port's distilled
  proposal carried into the reference so that no distillation draw
  enters. Each side builds its own occupancy grid. ≥ 40 dB, the
  reference's cross-path bound for renders
  (tests/kernels/test_slimmarch.py:201).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship as j_load_flagship
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.core.occupancy import build_jit as j_build_jit
from fashion_nerf.render.blockwise import \
    render_image_blockwise as j_render_image_blockwise
from fashion_nerf.render.renderer import render_image as j_render_image
from fashion_nerf.train.loop import make_fields as j_make_fields
from fashion_nerf_torch import quality
from fashion_nerf_torch.bench import bench_pose
from fashion_nerf_torch.kernels import carrymarch, sigmamarch, slimmarch
from fashion_nerf_torch.metrics import psnr

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_specs():
    """The `specs` list of scripts/quality_check.py's main, evaluated from
    its syntax tree: [(name, {keyword: value})]."""
    with open(os.path.join(ROOT, "scripts", "quality_check.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "specs"):
            rows = []
            for elt in node.value.elts:
                name, call = elt.elts
                assert isinstance(call, ast.Call) and call.func.id == "dict"
                rows.append((ast.literal_eval(name), {
                    kw.arg: ast.literal_eval(kw.value)
                    for kw in call.keywords}))
            return rows
    raise AssertionError("no specs list in scripts/quality_check.py")


def test_specs_are_the_reference_rows():
    assert quality.SPECS == _reference_specs()
    assert len(quality.SPECS) == 40


def test_every_row_takes_shapes_the_kernels_take(monkeypatch):
    """Each row at 8×8 through the plain versions, every march call's
    shapes held to the check its kernel runs on the card. The blockwise
    rows march: the proposal rows through the σ march (K1, or K2 above
    width 128) and the fine march (K2), the others through the coarse and
    fine march (K2); the dense, culled and fast rows march nothing."""
    calls = []

    def hooked(kind, real, check):
        def run(net, *args, **kw):
            R, SB = check(net, *args)
            calls.append((kind, R, SB, net.width))
            return real(net, *args, **kw)
        return run

    def k1(net, hoists, alive, t, d, *rest):
        sigmamarch.check_shapes(net, *d.shape)
        return d.shape

    def k2(net, hoists, dirpart, hit, block_hit, t, d, *rest):
        R, NB = block_hit.shape
        slimmarch.check_shapes(net, R, t.shape[1] // NB)
        return R, t.shape[1] // NB

    def k6(net, dirpart, rays_o, rays_d, hit, block_hit, t, d, *rest):
        R, NB = block_hit.shape
        carrymarch.check_shapes(net, R, t.shape[1] // NB)
        return R, t.shape[1] // NB

    monkeypatch.setattr(sigmamarch, "sigma_march", hooked(
        "sigma", sigmamarch.sigma_march_plain, k1))
    monkeypatch.setattr(slimmarch, "slim_march", hooked(
        "slim", slimmarch.slim_march_plain, k2))
    monkeypatch.setattr(carrymarch, "carry_march", hooked(
        "carry", carrymarch.carry_march_plain, k6))
    seen = {}

    def log(line):
        # each row's line comes right after its render: its calls so far
        name = max((n for n, _ in quality.SPECS
                    if line.startswith(n + " ")), key=len, default=None)
        if name is not None and name not in seen:
            seen[name] = list(calls)
            del calls[:]

    res = quality.run_sweep((), device="cpu", H=8, W=8, overrides=(
        "occupancy.resolution=16", "proposal.distill_steps=1",
        "proposal.distill_batch=64"), log=log)
    assert [r["name"] for r in res["rows"]] == [n for n, _ in quality.SPECS]
    assert all(np.isfinite(r["psnr_gt"]) for r in res["rows"])
    for name, kw in quality.SPECS:
        kinds = {k for k, _, _, _ in seen[name]}
        if not kw.get("blockwise"):
            assert not kinds, name
        elif kw.get("proposal"):
            assert kinds == {"sigma", "slim"}, (name, seen[name])
        else:
            assert kinds == {"slim"}, (name, seen[name])
        seen[name] = sorted({(k, sb) for k, _, sb, _ in seen[name]})
    # the rows' SBs: the fine march at kernels.block_samples (32, or 64),
    # the proposal's σ march at the preset's 64
    assert seen["blockwise carry 32+64 SB=64"] == [("slim", 64)]
    assert seen["proposal p64+f64+cov16 w256d3"] == [("sigma", 64),
                                                      ("slim", 32)]


# the four rows against the reference's renders, at 16×16
ROWS = ("dense 64+128", "culled 64+128", "blockwise carry 32+64",
        "proposal p64+f48+cov16 dil2")
SMALL = ("occupancy.resolution=32", "proposal.distill_steps=20",
         "proposal.distill_batch=256", "render.chunk=256")


@pytest.fixture(scope="module")
def sweep():
    return quality.run_sweep(list(ROWS), device="cpu", H=16, W=16,
                             overrides=SMALL, log=lambda m: None)


def _reference_render(name, kw, prop):
    """The reference's render of one row (scripts/quality_check.py:177-211)
    at 16×16, its Pallas marches in interpret mode, with the proposal
    net `prop` (a parameter tree) in place of a distilled one."""
    params, _ = j_load_flagship()
    n_c, n_f = kw["n_coarse"], kw["n_fine"]
    cfg = j_load_config("blender_lego", [
        f"sampling.n_coarse={n_c}", f"sampling.n_fine={n_f}",
        f"render.eval_n_coarse={n_c}", f"render.eval_n_fine={n_f}",
        "occupancy.enabled=true"] + (
        ["kernels.use_pallas=true", "kernels.interpret=true"]
        if kw.get("blockwise") else []) + list(kw.get("extra", ()))
        + list(SMALL))
    field_c, field_f = j_make_fields(cfg)
    occ = j_build_jit(cfg, field_f, params["fine"]) if kw["occ_on"] else None
    focal, c2w = bench_pose(16)
    pose = jnp.asarray(c2w)
    if kw.get("blockwise"):
        rparams = dict(params)
        if prop is not None:
            rparams["proposal"] = prop
        img = j_render_image_blockwise(rparams, cfg, 16, 16, focal, pose,
                                       occ=occ)["rgb"]
    else:
        img = j_render_image(
            lambda p, v, c=None: field_c(params["coarse"], p, v, c),
            lambda p, v, c=None: field_f(params["fine"], p, v, c),
            16, 16, focal, pose, cfg, occ=occ)["rgb"]
    return torch.from_numpy(np.array(jax.device_get(img)))


@pytest.mark.parametrize("name", ROWS)
def test_rows_match_reference(sweep, name):
    kw = dict(quality.SPECS)[name]
    row = next(r for r in sweep["rows"] if r["name"] == name)
    prop = (row["proposal"]["net"].to_flax_params() if kw.get("proposal")
            else None)
    ref = _reference_render(name, kw, prop)
    assert tuple(row["image"].shape) == (16, 16, 3)
    assert float(psnr(row["image"], ref)) >= 40.0
    if name != "dense 64+128":
        assert row["delta"] == pytest.approx(
            row["psnr_gt"] - sweep["rows"][0]["psnr_gt"])
    if kw.get("proposal"):
        assert 0.0 <= row["proposal"]["share"] <= 1.0
