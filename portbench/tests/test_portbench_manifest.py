"""BENCHMARK.json and the files it names: names, units, cells, metrics."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
CELLS = [w["name"] for w in M["workloads"]]
E2E = {m["name"]: m for m in M["end_to_end"]}


def reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for entry in M[section]:
        extra = set(entry) - KEYS[section]
        assert KEYS[section] <= set(entry), entry
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer") else set())


def test_names_and_units_use_the_allowed_characters():
    names = []
    for section in KEYS:
        for entry in M[section]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(set(names)) == len(names)


def test_every_cell_takes_one_chip():
    assert CELLS and all(w["chips"] == 1 for w in M["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        E2E["setup_s"]


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_s_cells_report_what_it_moves(metric):
    moves = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert reported(moves, cell), (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in M["end_to_end"] if reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reported(m, cell) for m in M["per_layer"])


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers == {"renderer", "step and graph", "kernels",
                      "scene set-up", "device"}


def test_roofline_names():
    rooflines = [m for m in M["per_layer"] if "roofline" in m["name"]]
    assert rooflines
    for m in rooflines:
        assert m["name"].endswith("_roofline"), m["name"]
        assert m["unit"] == "%" and m["source"] == "device_trace"


def test_the_harness_finds_every_file_by_name():
    for c in M["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        doc = json.loads(path.read_text())
        assert doc["name"] == c["name"] and doc["assumed"]
        assert c["reduced"] == []
    for w in M["workloads"]:
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PKG / "cells" / f"{w['name']}.json").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    files = [ROOT / c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)


def test_command_stays_in_paths():
    cmd = M["command"]
    assert len(cmd) <= 32 and cmd[:3] == ["python3", "-m", "portbench.run"]
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_cell_limits_cover_every_number():
    from portbench import check
    for cell in CELLS:
        doc = json.loads((PKG / "cells" / f"{cell}.json").read_text())
        assert set(doc["limits"]) == set(check.NUMBERS)
        assert doc["limits"]["count_mismatch"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_from_their_files(cell):
    """Each cell of BENCHMARK.json loads by name from its entry and the
    files it names; a name BENCHMARK.json lacks raises KeyError."""
    from portbench import harness
    c = harness.load_cell(cell, 5)
    entry = next(w for w in M["workloads"] if w["name"] == cell)
    conf = next(x for x in M["configs"] if x["name"] == entry["config"])
    assert c.workload == entry and c.chips == entry["chips"]
    assert c.config == json.loads((ROOT / conf["file"]).read_text())
    assert c.mix == json.loads(
        (PKG / "traffic" / f"{entry['traffic']}.json").read_text())
    assert c.ref_cfg["seed"] == 5 and c.ref_cfg["spp_per_step"] == (
        c.mix["spp_per_step"])
    with pytest.raises(KeyError):
        harness.load_cell(cell + "-nothing", 5)
