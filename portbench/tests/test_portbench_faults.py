"""The output check fails what it must: the timed path broken underneath
(a step that leaves its state unchanged, half of a step's tiles left out,
an answer altered where it is produced) and the control (the reference in
bfloat16 put in the program's place) come out not correct; the sound path
comes out correct; so does a program that renders without MIS, or
without NEE, where the configuration has both. A small frame on the CPU
through the port's plain step, skipping the harness's look for a card."""

import json
from pathlib import Path

import pytest

from portbench import check, control, harness, scan
from portbench.tests.frames import NEE_MIX, NEE_SMALL, SMALL, SMALL_MIX

CELLS = ["spheres128.converge", "spheres128.orbit", "tri32k.converge",
         "tri32k.rows", "tri32k-nee.converge"]
SEED = 2 ** 31 + 77


def run(cell):
    result, lines = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                                     backend="torch", overrides=SMALL,
                                     mix_overrides=SMALL_MIX.get(cell))
    assert len(lines) == len(check.NUMBERS)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell):
    result = run(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(v["value"] == 0 for v in result["checks"].values())
    json.dumps(result)


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("cell", ["spheres128.converge", "tri32k.rows",
                                  "spheres128.orbit", "tri32k-nee.converge"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    control.plant(fault, monkeypatch.setattr)
    result = run(cell)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    limits = json.loads((Path(check.__file__).parent / "cells"
                         / f"{cell}.json").read_text())["limits"]
    got = dict(control.readings(cell, SEED, 0.2, "cpu", "torch", True,
                                SMALL, SMALL_MIX.get(cell)))
    assert all(v == 0 for v in got["program"].values())
    assert not check.passes({k: (v, limits[k])
                             for k, v in got["control"].items()})


@pytest.mark.parametrize("setting", [{"mis": False},
                                     {"nee": False, "mis": False}],
                         ids=["mis_off", "nee_off"])
def test_a_program_without_mis_or_nee_is_not_correct(setting):
    cell = "tri32k-nee.converge"
    limits = json.loads((Path(check.__file__).parent / "cells"
                         / f"{cell}.json").read_text())["limits"]
    got = dict(control.readings(cell, SEED, 0.2, "cpu", "torch", False,
                                NEE_SMALL, NEE_MIX, setting))
    assert not check.passes({k: (v, limits[k])
                             for k, v in got["program"].items()})


@pytest.mark.parametrize("fault", [None, "altered"])
def test_the_scan_finds_where_the_program_parts(fault, monkeypatch):
    """portbench.scan: no pixel differs on the sound path; an altered
    answer shows at the checked pixels, with the reference's samples and
    the witness beside it (here the plain path itself, the fault planted
    in it too, so it sides with the program)."""
    if fault:
        control.plant(fault, monkeypatch.setattr)
    lines = list(scan.scan("tri32k.converge", SEED, 2, first=1,
                           witness=True, device="cpu", backend="torch",
                           overrides=SMALL, mix_overrides={"steps_per_call":
                                                           1}))
    assert [x["call"] for x in lines] == [1, 2]
    if fault is None:
        assert all(x["differ"] == 0 and x["numbers"]["accum_gap"] == 0
                   and x["off_mesh"]["casts"] == 0 for x in lines)
        return
    px = lines[0]["pixels"][0]
    assert lines[0]["differ"] >= 1 and px["program"][0] != px["reference"][0]
    assert px["witness"] == px["program"] and px["samples"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, card):
    result, _ = harness.run_cell(cell, SEED, 0.5, True, card,
                                 overrides=dict(SMALL, width=1024, height=64))
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
