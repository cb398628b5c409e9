"""The port's stage spans (``longtr_tpu_torch.utils.timers``) and the
pair-HMM cell counters.

* Spans nest per thread, carry their depth and thread, and each name's
  total is the sum of its recorded spans, in a unit case and in a run of
  the CLI.
* With recording off nothing is recorded, and ``--metrics-out`` keeps
  every stage name it had before the spans.
* A ``--jax-profile`` trace holds the stages as ranges.
* ``score_pairs_async`` counts the padded and the real DP cells exactly.
"""

import glob
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from longtr_tpu_torch.cli import main as port_main
from longtr_tpu_torch.pipeline.seq_genotyper import score_pairs_async
from longtr_tpu_torch.testing.catalogs import dryrun_catalog
from longtr_tpu_torch.testing.synth import standard_fixture
from longtr_tpu_torch.utils import timers
from longtr_tpu_torch.utils.timers import ProcessTimer, record_spans, span

CPU = torch.device("cpu")
MAIN = threading.main_thread().name

# the stage names a run of the standard fixture wrote before the spans
STAGES_BEFORE = {"BAM seek", "Read filtering", "SNP info extraction",
                 "Stutter estimation", "Trimming alignment", "Genotyping",
                 "Build wait", "Haplotype build", "Device dispatch",
                 "Device sync wait"}
# the stages inside the pass, and where each new one nests
NESTED_IN = {"BAM window decode": "BAM seek", "BAM record build": "BAM seek",
             "Build inline": "Genotyping", "Pair packing": "Device dispatch",
             "Call finalize": "Genotyping", "VCF write": "Genotyping",
             "Device dispatch": "Genotyping", "Pass open": "Pass",
             "Pass close": "Pass", "BAM seek": "Pass", "Genotyping": "Pass",
             "Mode B device": "Mode B dispatch",
             "Mode B marginalize": "Mode B dispatch"}
MODE_B = ["--stutter-align-len", "25", "--haploid-chrs", "chrH",
          "--use-unpaired"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return standard_fixture(str(tmp_path_factory.mktemp("synth")))


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    return dryrun_catalog(str(tmp_path_factory.mktemp("dryrun")))


@pytest.fixture
def recording():
    """Span recording on for the test; off again however it ends."""
    spans = record_spans(True)
    try:
        yield spans
    finally:
        record_spans(False)


def _run(fx, tmp_path, extra=()):
    out = str(tmp_path / "out.vcf.gz")
    metrics = str(tmp_path / "metrics.json")
    assert port_main(["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
                      "--regions", fx["bed"], "--tr-vcf", out,
                      "--min-reads", "5", "--quiet", "--metrics-out", metrics,
                      *extra], device=CPU) == 0
    with open(metrics) as fh:
        return json.load(fh)


def _totals(spans):
    out = {}
    for name, t0, t1, _depth, _thread in spans:
        out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def test_spans_nest_per_thread_and_sum_to_the_totals(recording):
    timer = ProcessTimer()

    def build():
        with timer.span("Built"):
            pass

    with timer.span("Outer", rest="Rest"):
        with span("Inner"):            # the timer of the span open here
            with span("Innermost"):
                pass
        with timer.span("Inner"):
            pass
        with ThreadPoolExecutor(1, thread_name_prefix="builder") as pool:
            pool.submit(build).result()
    with span("No timer"):             # no span open: recorded only
        pass
    got = {(name, depth, thread) for name, _a, _b, depth, thread in recording}
    assert got == {("Outer", 1, MAIN), ("Inner", 2, MAIN),
                   ("Innermost", 3, MAIN), ("Built", 1, "builder_0"),
                   ("No timer", 1, MAIN)}
    outer = next(s for s in recording if s[0] == "Outer")
    for name, a, b, _d, thread in recording:
        if thread == MAIN and name not in ("Outer", "No timer"):
            assert outer[1] <= a <= b <= outer[2]
    sums = _totals(recording)
    assert set(timer.totals) == {"Outer", "Inner", "Innermost", "Built",
                                 "Rest"}
    for name in ("Outer", "Inner", "Innermost", "Built"):
        assert timer.totals[name] == pytest.approx(sums[name], rel=1e-12)
    # Rest: the outer span less its direct children on its own thread
    assert timer.totals["Rest"] == pytest.approx(
        sums["Outer"] - sums["Inner"], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("surface", ["core", "mode-b"])
def test_a_runs_spans_nest_and_sum_to_its_stage_seconds(
        request, tmp_path, recording, surface):
    if surface == "core":
        m = _run(request.getfixturevalue("synth"), tmp_path)
    else:
        m = _run(request.getfixturevalue("dryrun"), tmp_path, MODE_B)
    stage = m["stage_seconds"]
    if surface == "mode-b":
        assert {"Mode B dispatch", "Mode B device",
                "Mode B marginalize"} <= set(stage)
    sums = _totals(recording)
    assert set(stage) == set(sums) | {"Outside stages"}
    for name, total in stage.items():
        if name != "Outside stages":
            assert total == pytest.approx(sums[name], rel=1e-9), name
    main = [s for s in recording if s[4] == MAIN]
    (pass_span,) = [s for s in main if s[0] == "Pass"]
    assert pass_span[3] == 1
    direct = sum(b - a for _n, a, b, d, _t in main if d == 2)
    assert stage["Outside stages"] == pytest.approx(
        (pass_span[2] - pass_span[1]) - direct, rel=1e-6, abs=1e-9)
    assert 0 <= stage["Outside stages"] < stage["Pass"]
    # each child lies inside a parent span of the name it nests in, one
    # level up
    for name, a, b, depth, _t in main:
        if name in NESTED_IN:
            assert any(p[0] == NESTED_IN[name] and p[3] == depth - 1
                       and p[1] <= a and b <= p[2] for p in main), name
    for name, *_rest, thread in recording:
        if name == "Haplotype build" and thread != MAIN:
            assert thread.startswith("longtr-hapgen"), thread
    assert m["cells_launched"] >= m["cells_real"] > 0


def test_recording_off_records_nothing_and_keeps_the_stage_names(
        synth, tmp_path):
    record_spans(True)
    before = record_spans(False)
    n = len(before)
    m = _run(synth, tmp_path)
    assert len(before) == n
    assert timers._recorded is None
    assert STAGES_BEFORE <= set(m["stage_seconds"])
    assert {"Pass", "Outside stages", "BAM window decode", "Build inline",
            "Pair packing", "Call finalize", "VCF write"} <= set(
                m["stage_seconds"])


def test_profile_trace_holds_the_stage_ranges(synth, tmp_path):
    prof = str(tmp_path / "prof")
    _run(synth, tmp_path, ["--jax-profile", prof])
    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    with open(path) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert {"BAM seek", "Device dispatch", "Pair packing",
            "Genotyping"} <= names


def test_cells_launched_and_real_are_exact():
    def scorer(hap, hap_lens, read, read_lens, full_lens, params):
        return np.zeros(len(hap_lens))

    pairs = [("A" * 10, "C" * 12, 30), ("G" * 20, "T" * 5, 30),
             ("A" * 100, "C" * 90, 150)]
    handle = score_pairs_async(pairs, scorer=scorer)
    # length class 64: pairs 0 and 1 padded to 128 rows of 64 x 64 cells;
    # class 128: pair 2 padded to 128 rows of 128 x 128
    assert handle.n_cells_launched == 128 * 64 * 64 + 128 * 128 * 128
    assert handle.n_cells_real == 10 * 12 + 20 * 5 + 100 * 90
    assert handle.n_dispatches == 2
    empty = score_pairs_async([], scorer=scorer)
    assert (empty.n_cells_launched, empty.n_cells_real) == (0, 0)


def test_threads_lose_no_update_of_a_total():
    """Builder threads add to one timer: no add is lost under contention."""
    timer = ProcessTimer()
    n_threads, n_adds = min(32, 2 * (os.cpu_count() or 4)), 20000

    def work():
        for _ in range(n_adds):
            timer.add("Built", 1.0)
        for _ in range(100):
            with timer.span("Span"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert timer.totals["Built"] == n_threads * n_adds
    assert timer.snapshot()["Span"] > 0
