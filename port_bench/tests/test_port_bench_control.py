"""The control and the planted faults come out not correct; the program
comes out correct.  On the CPU, at a size a test run holds: the program
takes its plain versions there, the reference is the same either way."""

import time

import pytest
import torch

from _paths import HARNESS
from pbench import cells, control, runner

CELL = "str_mix.hifi_trio"


def _run(monkeypatch, hook=None, seed=11):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    cell = cells.find(HARNESS + "/..", HARNESS, CELL)
    cell.traffic.update(n_loci=12, warm_loci=2)
    cell.config["reads"]["coverage"] = 10
    cell.checks["sample"].update(loci=6, rows_per_call=10 ** 6)
    return runner.run_cell(cell, HARNESS, seed, 0.5, 0, torch.device("cpu"),
                           time.perf_counter(), log=lambda s: None,
                           setup_hook=hook)


def test_the_program_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"] is True
    assert set(res["checks"]) == {"pairhmm_gap", "vcf_gap"}


def test_the_bfloat16_control_fails_every_number(monkeypatch):
    res = _run(monkeypatch, control.bf16_control)
    assert res["correct"] is False
    for name, v in res["checks"].items():
        assert v["value"] > v["limit"], name


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer",
                                   "phasing_dropped"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    res = _run(monkeypatch, getattr(control, fault))
    assert res["correct"] is False
