"""The port's own copy of the parity harness (fashion_nerf_torch.parity)
against the reference's, on the cases of tests/unit/test_parity.py: the two
anchor tables, `anchor_for`, `anchor_row`, `scene_dirs` and `run_parity`
give equal results (exact) and print equal lines."""

import json
import os

import pytest

from fashion_nerf import parity as jparity
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf_torch import parity
from fashion_nerf_torch.config import load_config


def test_anchor_tables_equal_reference():
    assert parity.BLENDER_ANCHORS == jparity.BLENDER_ANCHORS
    assert parity.LLFF_ANCHORS == jparity.LLFF_ANCHORS
    assert parity.PARITY_GATE_DB == jparity.PARITY_GATE_DB


@pytest.mark.parametrize("root,dataset,want", [
    ("/data/nerf_synthetic/lego", "blender", 32.54),
    ("/data/nerf_synthetic/lego/", "blender", 32.54),
    ("/data/nerf_synthetic/LEGO", "blender", 32.54),
    ("/data/llff/fern", "llff", 25.17),
    ("/data/llff/unknown_scene", "llff", None),
    ("/data/x/lego", "tiny", None)])
def test_anchor_for_equals_reference(root, dataset, want):
    assert parity.anchor_for(root, dataset) == want
    assert jparity.anchor_for(root, dataset) == want


@pytest.mark.parametrize("root,psnr,passes", [
    ("/d/lego", 32.50, True),       # -0.04 dB, within the 0.1 gate
    ("/d/lego", 32.30, False),      # -0.24 dB
    ("/d/lego", 33.00, True),       # beating the anchor passes
    ("/d/nope", 30.0, None)])
def test_anchor_row_equals_reference(root, psnr, passes):
    row = parity.anchor_row(root, "blender", psnr)
    assert row == jparity.anchor_row(root, "blender", psnr)
    assert row.get("parity") is passes


def _scenes(tmp_path, names=("lego", "ship")):
    for scene in names:
        d = tmp_path / scene
        d.mkdir()
        (d / "transforms_train.json").write_text("{}")
    (tmp_path / "not_a_scene").mkdir()


def test_scene_dirs_equals_reference(tmp_path):
    _scenes(tmp_path)
    found = parity.scene_dirs(str(tmp_path), "blender")
    assert [os.path.basename(f) for f in found] == ["lego", "ship"]
    for root, dataset in ((tmp_path, "blender"), (tmp_path / "lego",
                                                  "blender"),
                          (tmp_path, "llff")):
        assert (parity.scene_dirs(str(root), dataset)
                == jparity.scene_dirs(str(root), dataset))
    assert parity.scene_dirs(str(tmp_path / "lego"), "blender") == [
        str(tmp_path / "lego")]


def test_run_parity_sweep_equals_reference(tmp_path, capsys):
    _scenes(tmp_path)
    ovr = [f"data.root={tmp_path}", "data.dataset=blender"]
    scores = {"lego": (32.60, 0.96), "ship": (28.00, 0.87)}

    def eval_scene(scene_cfg):
        return scores[os.path.basename(scene_cfg.data.root)]

    rows = parity.run_parity(load_config("blender_lego", ovr), eval_scene)
    printed = capsys.readouterr().out
    rows_j = jparity.run_parity(j_load_config("blender_lego", ovr),
                                eval_scene)
    assert rows == rows_j and printed == capsys.readouterr().out
    by_scene = {r["scene"]: r for r in rows}
    assert by_scene["lego"]["parity"] is True      # +0.06 against 32.54
    assert by_scene["ship"]["parity"] is False     # -0.65 against 28.65
    summary = json.loads(printed.strip().splitlines()[-1])
    assert summary["scenes"] == 2 and summary["parity_pass"] == 1


def test_run_parity_without_scenes(tmp_path, capsys):
    """No scene under the root: no rows, and the error line on stderr, as
    the reference prints it."""
    ovr = [f"data.root={tmp_path}", "data.dataset=blender"]
    assert parity.run_parity(load_config("blender_lego", ovr), None) == []
    err = capsys.readouterr().err
    assert jparity.run_parity(j_load_config("blender_lego", ovr), None) == []
    assert err == capsys.readouterr().err
    assert json.loads(err)["error"] == "no scenes found"
