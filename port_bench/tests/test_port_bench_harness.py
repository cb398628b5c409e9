"""The harness on the CPU: discovery by name, a cell added as data, the
per-layer arithmetic, the result line, and no run without a card."""

import io
import json
import os
import shutil
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from _paths import HARNESS, ROOT
from pbench import cells, runner, trace
from pbench.readers import Window

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_cell_finds_its_files_by_name():
    bench = cells.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = cells.find(ROOT, HARNESS, w["name"])
        assert cell.traffic["name"] == w["traffic"]
        assert cell.config["name"] == w["config"]
        assert set(cell.checks["limits"]) >= {"vcf_gap"}
        for m in cell.per_layer:
            assert callable(cells.reader(HARNESS, m["name"]))
        names = [m["name"] for m in cell.end_to_end]
        assert names == ["loci_per_s", "setup_s"]
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HARNESS, "metrics",
                                           m["name"] + ".py"))


def _copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HARNESS, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _small(cell):
    cell.traffic.update(n_loci=8, warm_loci=2)
    cell.config["reads"]["coverage"] = 8
    cell.checks["sample"].update(loci=4, rows_per_call=10 ** 6)
    return cell


def _run(cell, harness, seed=7, trace_=0, hook=None):
    return runner.run_cell(cell, harness, seed, 0.5, trace_,
                           torch.device("cpu"), time.perf_counter(),
                           log=lambda s: None, setup_hook=hook)


def test_a_new_cell_is_data_only(tmp_path, monkeypatch):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    root = _copy_benchmark(tmp_path)
    harness = root / "port_bench"
    mix = cells.load_json(harness / "traffic" / "str_mix.json")
    mix.update(name="tri_only", motifs=["CTG"], n_loci=8)
    (harness / "traffic" / "tri_only.json").write_text(json.dumps(mix))
    (harness / "checks" / "tri_only.hifi_trio.json").write_text(
        (harness / "checks" / "str_mix.hifi_trio.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tri_only.hifi_trio",
                               "config": "hifi_trio", "traffic": "tri_only",
                               "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = _small(cells.find(str(root), str(harness), "tri_only.hifi_trio"))
    assert {l for l in cell.traffic["motifs"]} == {"CTG"}
    res = _run(cell, str(harness))
    assert res["correct"] is True
    assert res["attempted"] % 8 == 0 and res["attempted"] >= 8
    assert res["failed"] == 0
    assert set(res["checks"]) == {"pairhmm_gap", "vcf_gap", "unscored_share"}


def test_result_line_has_the_contracts_keys(monkeypatch):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    cell = _small(cells.find(ROOT, HARNESS, "str_mix.hifi_trio"))
    res = _run(cell, HARNESS)
    assert list(res) == CONTRACT_KEYS + ["checks"]
    assert set(res["metrics"]) == {"loci_per_s", "setup_s"}
    assert res["metrics"]["loci_per_s"]["unit"] == "loci/s"
    assert res["metrics"]["loci_per_s"]["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = runner.main(["--workload", "str_mix.hifi_trio", "--seed", "3",
                          "--seconds", "1", "--trace", "0"],
                         time.perf_counter(), HARNESS, ROOT)
    assert rc != 0
    assert out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def _canned_window():
    metrics_out = {"loci_processed": 64, "num_genotype_success": 64,
                   "stage_seconds": {"BAM seek": 0.064, "Read filtering": 0.032,
                                     "Trimming alignment": 0.032,
                                     "Build wait": 0.016,
                                     "Device dispatch": 0.008,
                                     "Device sync wait": 0.004}}
    ops = [("fill_marker", 0.0, 0.001),
           ("void pairhmm_resident_warp_kernel<4>", 1.0, 1.1),
           ("void pairhmm_resident_warp_kernel<4>", 1.05, 1.2),
           ("Memcpy HtoD", 1.5, 1.6),
           ("void pairhmm_resident_block_kernel<2>", 3.0, 3.4)]
    spans = [("pass", 0.5, 4.5, 1), ("pairhmm_batch_auto", 0.9, 1.0, 2),
             ("score_sync", 2.5, 3.6, 2)]
    summary = trace.summarize(ops, spans, 0.5, 4.5)
    counters = {"cells_launched": 4096, "cells_real": 3072,
                "reads_from_columns": 300, "reads_fallback": 100}
    return Window(64, metrics_out["stage_seconds"], 128, {"pairhmm": 0.065},
                  summary, counters)


def test_per_layer_arithmetic_on_a_canned_run():
    w = _canned_window()
    read = lambda name: cells.reader(HARNESS, name)(w)
    assert read("reads.ms_per_locus") == pytest.approx(2.0)
    assert read("hapbuild.wait_ms_per_locus") == pytest.approx(0.25)
    assert read("dispatch.ms_per_locus") == pytest.approx(0.125)
    assert read("dispatch.launches_per_locus") == pytest.approx(2.0)
    assert read("finalize.sync_wait_ms_per_locus") == pytest.approx(0.0625)
    # busy: [1.0, 1.2] + [1.5, 1.6] + [3.0, 3.4] = 0.7 of a 4 s window
    assert w.trace["busy_s"] == pytest.approx(0.7)
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 0.7 / 4))
    # bound over the named kernels' summed device time (0.1 + 0.15 + 0.4)
    assert read("pairhmm_roofline") == pytest.approx(100 * 0.065 / 0.65)
    assert read("dispatch.padded_cells_pct") == pytest.approx(25.0)
    assert read("reads.columns_pct") == pytest.approx(75.0)
    # the longest gap, [1.6, 3.0], lies in the pass outside any layer span
    name, secs = w.trace["idle_gaps"][0]
    assert name == "pass" and secs == pytest.approx(1.4)
    assert w.trace["device_ops"][0][0].startswith(
        "void pairhmm_resident_block")


def test_readers_return_nothing_where_there_is_nothing_to_read():
    w = Window(10, {"BAM seek": 1.0}, 0, {"pairhmm": 0.0})
    read = lambda name: cells.reader(HARNESS, name)(w)
    assert read("hapbuild.wait_ms_per_locus") is None
    assert read("dispatch.ms_per_locus") is None
    assert read("pairhmm_roofline") is None
    assert read("device.idle_pct") is None
    # a program that writes no counters, or counts nothing
    assert read("dispatch.padded_cells_pct") is None
    assert read("reads.columns_pct") is None
    w.counters.update(cells_launched=0, cells_real=0, reads_from_columns=0,
                      reads_fallback=0)
    assert read("dispatch.padded_cells_pct") is None
    assert read("reads.columns_pct") is None


class _FakeTrace:
    """Stands in for the profiler on the CPU: one marker and one kernel."""

    def __init__(self, device):
        self.t = None

    def start(self):
        self.t = time.perf_counter()

    def stop(self):
        t = self.t
        return [("fill_marker", t, t + 1e-4),
                ("void pairhmm_resident_warp_kernel<4>", t + 0.01, t + 0.02)]


def test_a_traced_run_reads_stages_untraced_and_the_device_traced(
        monkeypatch):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(trace, "DeviceTrace", _FakeTrace)
    cell = _small(cells.find(ROOT, HARNESS, "str_mix.hifi_trio"))
    res = _run(cell, HARNESS, trace_=1)
    assert res["correct"] is True
    names = {m["name"] for m in cell.per_layer}
    # no stage of the untraced window is empty, the bound is counted and
    # the device was busy in the traced one
    assert set(res["metrics"]) == names
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert 0.01 - 1e-9 <= res["device"]["busy_s"] <= 0.0101 + 1e-9
    assert res["breakdown"]["device_ops"][0][0].startswith("void pairhmm")
    s = res["_summary"]
    assert s["loci"] > 0 and s["traced_loci"] > 0
    # the counters are the untraced window's passes', summed
    assert s["counters"]["loci_processed"] == s["loci"]
    assert 0 < s["counters"]["cells_real"] < s["counters"]["cells_launched"]
    assert s["bound_s"]["pairhmm"] > 0
    assert res["attempted"] == s["loci"] + s["traced_loci"]
