"""The readers of the program's stage spans (``utils/timers.py``): their
arithmetic on a canned window, nothing read from a program without the
spans, and a traced run on the CPU that reports each of them."""

import pytest

from _paths import HARNESS, ROOT
from pbench import cells, trace
from pbench.readers import Window
from test_port_bench_harness import _FakeTrace, _canned_window, _run, _small

SPAN_METRICS = ["hapbuild.main_ms_per_locus", "reads.decode_ms_per_locus",
                "dispatch.pack_ms_per_locus", "finalize.host_ms_per_locus",
                "pass.untraced_ms_per_locus"]


def test_the_span_readers_on_a_canned_run():
    stage = {"Pass": 1.28, "Outside stages": 0.0032, "BAM seek": 0.064,
             "BAM window decode": 0.016, "Build inline": 0.128,
             "Build wait": 0.0016, "Genotyping": 0.4,
             "Device dispatch": 0.08, "Pair packing": 0.032,
             "Call finalize": 0.048, "VCF write": 0.016}
    w = Window(64, stage, 128, {"pairhmm": 0.065})
    read = lambda name: cells.reader(HARNESS, name)(w)
    assert read("hapbuild.main_ms_per_locus") == pytest.approx(2.025)
    assert read("reads.decode_ms_per_locus") == pytest.approx(0.25)
    assert read("dispatch.pack_ms_per_locus") == pytest.approx(0.5)
    assert read("finalize.host_ms_per_locus") == pytest.approx(1.0)
    assert read("pass.untraced_ms_per_locus") == pytest.approx(0.05)


def test_a_program_without_the_spans_gives_none_of_them():
    # the stages a program wrote before the spans (Build wait among them)
    old = _canned_window()
    assert [cells.reader(HARNESS, n)(old) for n in SPAN_METRICS] == \
        [None] * len(SPAN_METRICS)


def test_a_traced_run_reports_every_span_metric(monkeypatch):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(trace, "DeviceTrace", _FakeTrace)
    cell = _small(cells.find(ROOT, HARNESS, "str_mix.hifi_trio"))
    res = _run(cell, HARNESS, trace_=1)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in SPAN_METRICS:
        assert got[name] >= 0, name
    # every str_mix locus builds inline, on the main thread
    assert got["hapbuild.main_ms_per_locus"] > 10 * got[
        "hapbuild.wait_ms_per_locus"]
    assert got["reads.decode_ms_per_locus"] < got["reads.ms_per_locus"]
    assert got["dispatch.pack_ms_per_locus"] < got["dispatch.ms_per_locus"]
    stage = res["_summary"]["stage_s"]
    assert stage["Outside stages"] < stage["Pass"]
