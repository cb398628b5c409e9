"""Mode B's span and counters in a run's ``--metrics-out``, on the CPU.

A ``longtr`` run of the dryrun catalog with ``--stutter-align-len 25``
reports the ``Mode B prepare`` span and the five ``mode_b_*`` counters
(one locus for each of the catalog's homopolymers; no more real row-DP
elements than launched); without the flag every counter is 0 and no
mode-B span is open.  Counting changes no call: the VCF equals the JAX
package's byte for byte, as it did before the counters
(``tests/test_torch_slice.py``).
"""

import gzip
import json

import pytest
import torch

from longtr_tpu.cli import main as jax_main
from longtr_tpu_torch.cli import main as port_main
from longtr_tpu_torch.pipeline.seq_genotyper import MODE_B_COUNTERS
from longtr_tpu_torch.testing.catalogs import dryrun_catalog
from longtr_tpu_torch.utils.timers import record_spans

MODE_B = ["--stutter-align-len", "25"]
# the dryrun catalog's homopolymers (chr1 and chr2, loci 4 and 9)
HOMOPOLYMERS = 4


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    return dryrun_catalog(str(tmp_path_factory.mktemp("dryrun")))


def _argv(fx, out, extra):
    return ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--tr-vcf", out, "--min-reads", "5",
            "--quiet", "--use-unpaired", *extra]


def _run(fx, tmp_path, extra):
    out = str(tmp_path / "port.vcf.gz")
    metrics = str(tmp_path / "metrics.json")
    assert port_main(_argv(fx, out, extra + ["--metrics-out", metrics]),
                     device=torch.device("cpu")) == 0
    with open(metrics) as fh:
        return json.load(fh), out


def _body(path):
    with gzip.open(path, "rt") as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith("##command")]


def test_a_mode_b_run_reports_its_span_and_counters(dryrun, tmp_path):
    spans = record_spans(True)
    try:
        m, _out = _run(dryrun, tmp_path, MODE_B)
    finally:
        record_spans(False)
    stage = m["stage_seconds"]
    assert {"Mode B prepare", "Mode B dispatch", "Mode B device",
            "Mode B marginalize"} <= set(stage)
    prepare = [s for s in spans if s[0] == "Mode B prepare"]
    assert len(prepare) >= HOMOPOLYMERS
    assert stage["Mode B prepare"] == pytest.approx(
        sum(b - a for _n, a, b, _d, _t in prepare), rel=1e-9)
    assert m["mode_b_loci"] == HOMOPOLYMERS
    assert m["mode_b_reads"] >= HOMOPOLYMERS
    assert 0 < m["mode_b_elements_real"] <= m["mode_b_elements_launched"]
    assert 0 <= m["mode_b_host_reads"] <= m["mode_b_reads"]


def test_without_the_flag_mode_b_counts_nothing(dryrun, tmp_path):
    m, _out = _run(dryrun, tmp_path, [])
    assert all(m[k] == 0 for k in MODE_B_COUNTERS)
    assert not {s for s in m["stage_seconds"] if s.startswith("Mode B")}


def test_counting_changes_no_call(dryrun, tmp_path):
    _m, out = _run(dryrun, tmp_path, MODE_B)
    want = str(tmp_path / "jax.vcf.gz")
    assert jax_main(_argv(dryrun, want, MODE_B)) == 0
    got = _body(out)
    assert sum(1 for ln in got if not ln.startswith("#")) > HOMOPOLYMERS
    assert got == _body(want)
