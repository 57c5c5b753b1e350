"""The check catches what it is there to catch: at a size a CPU test
run holds, with the harness's look for a card skipped and the rest of a
run driven as on the card, every fault planted in the timed path makes
``correct`` false, and so do the controls (the reference's own search
at a lower precision in the program's place; the program's optimizer
with its state in bfloat16); the sound run is correct."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench import calibrate, faults, harness
from portbench.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
#: the cells and the faults each can have (no projection at layer 0)
CASES = [(cell, kind) for cell in ("higgs11m.hier", "higgs11m.cached",
                                   "mnist70k.dense")
         for kind in faults.KINDS
         if kind != "projection" or cell.startswith("higgs")]
#: the control of each cell's limits: float32 searches judged against
#: TF32; the MNIST rows are integers 0..255, which TF32 and bfloat16
#: hold exactly, so their control is fp8
CONTROL = {"higgs11m.hier": "tf32", "higgs11m.cached": "tf32",
           "mnist70k.dense": "fp8"}


def _run(cell):
    return harness.run_cell(ROOT, cell, 2 ** 33 + 7, 0.0, False, 0.0,
                            device="cpu", overrides=tiny(cell),
                            log=lambda m: None)


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("cell,kind", CASES)
def test_planted_fault_is_caught(cell, kind):
    with faults.planted(kind):
        out = _run(cell)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_optimizer_control_is_not_correct(cell):
    with faults.planted("bf16_sweeps"):
        out = _run(cell)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_is_not_correct(cell):
    limits = harness.Cell.load(ROOT, cell).limits
    recs = calibrate.calibrate(ROOT, cell, [2 ** 35 + 1], [CONTROL[cell]],
                               [], device="cpu", overrides=tiny(cell),
                               emit=lambda rec: None)
    by = {r["reading"]: r for r in recs}
    assert harness.is_correct(harness.compared(by["sound"], limits))
    assert not harness.is_correct(harness.compared(
        by[f"control_{CONTROL[cell]}"], limits))
