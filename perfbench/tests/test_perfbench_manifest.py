"""BENCHMARK.json against the benchmark's contract, and its files."""

import json
import os
import re

from perfbench import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_names():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(map(line_ok, b["command"]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line_ok(w["why"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in b["workloads"]} == {
        c["name"] for c in b["configs"]}
    assert len(json.dumps(b)) <= 64 * 1024


def test_bounds_and_sources():
    b = manifest()
    names = [m["name"] for m in b["end_to_end"]]
    assert "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in names and line_ok(m["layer"])


def reports(b, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_what_its_metrics_move():
    b = manifest()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = w["name"]
        assert reports(b, e2e["setup_s"], cell)
        assert any(reports(b, m, cell) for n, m in e2e.items()
                   if n != "setup_s")
        assert any(reports(b, m, cell) for m in b["per_layer"])
        for m in b["per_layer"]:
            if reports(b, m, cell):
                assert reports(b, e2e[m["moves"]], cell), (m["name"], cell)


def test_every_name_has_its_files():
    b = manifest()
    here = os.path.join(ROOT, "perfbench")
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           m["name"] + ".py")), m["name"]
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
        with open(os.path.join(here, "checks", w["name"] + ".json")) as f:
            assert json.load(f)["limits"], w["name"]
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["name"] == c["name"] and doc["reduced"] == c["reduced"]


def test_four_chip_cells_and_check_time():
    b = manifest()
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
