"""The mode-B cell (``hp_mix.hifi_trio_modeb``) on the CPU, at a size a
test run holds (12 loci at the configuration's depth, every one sampled;
fewer reads leave the chromosome's end loci with too few to genotype):
the program is correct and
scores every sampled locus; the reference in bfloat16, a wrong stutter
prior and homopolymers forced through the pair-HMM are not correct; the
traced run reads every metric the cell lists, and the readers of the
host reads and the haplotype build still read for ``str_mix.hifi_trio``.
"""

import time

import pytest
import torch

from _paths import HARNESS, ROOT
from pbench import cells, control_modeb, runner, trace
from test_port_bench_harness import _FakeTrace, _small

CELL = "hp_mix.hifi_trio_modeb"
MODE_B_METRICS = ["modeb.prepare_ms_per_locus", "modeb.device_ms_per_locus",
                  "modeb.marginalize_ms_per_locus",
                  "modeb.padded_elements_pct", "modeb.loci_pct"]


def _cell():
    cell = cells.find(ROOT, HARNESS, CELL)
    cell.traffic.update(n_loci=12, warm_loci=2)
    cell.checks["sample"].update(loci=12, rows_per_call=10 ** 6)
    return cell


def _run(monkeypatch, hook=None, seed=11, cell=None, trace_=0):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    return runner.run_cell(cell or _cell(), HARNESS, seed, 0.5, trace_,
                           torch.device("cpu"), time.perf_counter(),
                           log=lambda s: None, setup_hook=hook)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_program_is_correct_and_scores_every_locus(monkeypatch, seed):
    res = _run(monkeypatch, seed=seed)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["unscored_share"]["value"] == 0


@pytest.mark.parametrize("fault, number", [
    ("reference_bf16", "vcf_gap"), ("stutter_prior_090", "vcf_gap"),
    ("mode_b_bypassed", "unscored_share")])
def test_a_control_or_planted_fault_is_not_correct(monkeypatch, fault,
                                                   number):
    res = _run(monkeypatch, getattr(control_modeb, fault))
    v = res["checks"][number]
    assert res["correct"] is False
    assert v["value"] > v["limit"], (fault, v)


def test_a_traced_run_reads_every_metric_of_the_cell(monkeypatch):
    monkeypatch.setattr(trace, "DeviceTrace", _FakeTrace)
    cell = _cell()
    res = _run(monkeypatch, cell=cell, trace_=1)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {m["name"] for m in cell.per_layer}
    assert set(MODE_B_METRICS) <= set(got)
    # 9 of the 12 loci are homopolymers
    assert got["modeb.loci_pct"] == pytest.approx(75.0)
    assert 0 <= got["modeb.padded_elements_pct"] < 100
    s = res["_summary"]["counters"]
    assert 0 < s["mode_b_elements_real"] <= s["mode_b_elements_launched"]


@pytest.mark.parametrize("name", [
    "str_mix.hifi_trio", CELL])
def test_the_host_read_and_build_readers_read_in_every_cell(
        monkeypatch, name):
    monkeypatch.setattr(trace, "DeviceTrace", _FakeTrace)
    cell = _small(cells.find(ROOT, HARNESS, name))
    res = _run(monkeypatch, cell=cell, trace_=1)
    for metric in ("reads.ms_per_locus", "hapbuild.wait_ms_per_locus",
                   "dispatch.launches_per_locus", "device.idle_pct"):
        assert metric in {m["name"] for m in cell.per_layer}
        assert res["metrics"][metric]["value"] >= 0, metric
