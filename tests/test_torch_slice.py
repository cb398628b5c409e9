"""The default `longtr` run through the PyTorch port, on the CPU.

longtr_tpu_torch.cli.main must write VCF bodies byte-identical to
longtr_tpu.cli.main (excluding the ##command line) on the core surface of
__graft_entry__._dryrun_catalog and on the tests/synth.py fixture of
tests/test_e2e_pipeline.py, with and without --ref-fidelity.  The port
must import and run with JAX absent, refuse the options it has not ported,
and refuse a CUDA device that is not there.
"""

import gzip
import os
import subprocess
import sys
import textwrap

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth import standard_fixture  # noqa: E402

from longtr_tpu.cli import main as jax_main  # noqa: E402
from longtr_tpu_torch import device as port_device  # noqa: E402
from longtr_tpu_torch.cli import main as port_main  # noqa: E402
from longtr_tpu_torch.ops.pairhmm import pairs_scored  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def body(path):
    with gzip.open(path, "rt") as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith("##command")]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return standard_fixture(str(tmp_path_factory.mktemp("synth")))


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    sys.path.insert(0, REPO)
    from __graft_entry__ import _dryrun_catalog
    return _dryrun_catalog(str(tmp_path_factory.mktemp("dryrun")))


def _argv(fx, out, extra=()):
    return ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--tr-vcf", out, "--min-reads", "5",
            "--quiet", *extra]


def _both(fx, tmp_path, extra, route):
    """VCF bodies of the JAX package and of the port on one input; the
    port's pairs must all have gone through `route`."""
    out_jax = str(tmp_path / "jax.vcf.gz")
    out_port = str(tmp_path / "port.vcf.gz")
    assert jax_main(_argv(fx, out_jax, extra)) == 0
    before = dict(pairs_scored)
    assert port_main(_argv(fx, out_port, extra),
                     device=torch.device("cpu")) == 0
    moved = {k: pairs_scored[k] - before[k] for k in pairs_scored}
    assert moved[route] > 0 and sum(moved.values()) == moved[route], moved
    return body(out_jax), body(out_port)


@pytest.mark.parametrize("extra,route", [([], "cpu"),
                                         (["--ref-fidelity"], "host_f64"),
                                         (["--phased-bam"], "cpu")],
                         ids=["default", "ref_fidelity", "phased_bam"])
def test_synth_fixture_vcf_identical(synth, tmp_path, extra, route):
    from longtr_tpu.utils import mathops
    try:
        want, got = _both(synth, tmp_path, extra, route)
    finally:
        mathops.set_ref_fidelity(False)
    assert sum(1 for ln in want if not ln.startswith("#")) == len(synth["loci"])
    assert got == want


@pytest.mark.parametrize("extra", [[], ["--haploid-chrs", "chrH"]],
                         ids=["core", "haploid"])
def test_dryrun_surface_vcf_identical(dryrun, tmp_path, extra):
    """The core surface, and haploid calling (host code only)."""
    want, got = _both(dryrun, tmp_path, ["--use-unpaired", *extra], "cpu")
    assert sum(1 for ln in want if not ln.startswith("#")) > 10
    assert got == want


def test_em_training_identical(dryrun, tmp_path):
    """--no-def-stutter-model: the port trains stutter models on the host
    (no mesh); the learned models and the calls match longtr_tpu's."""
    outs = {}
    for tag, main in (("jax", jax_main), ("port", port_main)):
        vcf = str(tmp_path / f"{tag}.vcf.gz")
        models = tmp_path / f"{tag}_stutter.txt"
        argv = _argv(dryrun, vcf, ["--use-unpaired", "--no-def-stutter-model",
                                   "--stutter-out", str(models)])
        assert (main(argv) if tag == "jax" else main(argv, device="cpu")) == 0
        outs[tag] = (body(vcf), models.read_text())
    assert outs["port"] == outs["jax"]
    assert len(outs["jax"][1].splitlines()) > 10


def test_imports_and_runs_without_jax(synth, tmp_path):
    """In a fresh interpreter where `import jax` fails, every module of the
    port imports and its CLI genotypes the synth fixture."""
    out = str(tmp_path / "nojax.vcf.gz")
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import longtr_tpu_torch
        for m in pkgutil.walk_packages(longtr_tpu_torch.__path__,
                                       "longtr_tpu_torch."):
            importlib.import_module(m.name)
        from longtr_tpu_torch.cli import main
        rc = main({_argv(synth, out)!r}, device="cpu")
        assert "jax" not in [k.split(".")[0] for k, v in sys.modules.items()
                             if v is not None]
        sys.exit(rc)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = str(tmp_path / "jax.vcf.gz")
    assert jax_main(_argv(synth, want)) == 0
    assert body(out) == body(want)


@pytest.mark.parametrize("flag", [
    ["--workers", "2"], ["--distributed"], ["--jax-profile", "prof"],
    ["--stutter-align-len", "25"], ["--snp-vcf", "snps.vcf.gz"],
    ["--ref-vcf", "panel.vcf.gz"]], ids=lambda f: f[0])
def test_unported_flags_exit(flag, capsys):
    argv = ["--bams", "x.bam", "--fasta", "g.fa", "--regions", "r.bed",
            "--tr-vcf", "out.vcf.gz", *flag]
    with pytest.raises(SystemExit) as exc:
        port_main(argv, device="cpu")
    assert f"{flag[0]} is not yet ported to longtr_tpu_torch" in str(
        exc.value.code)


def test_select_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_device.select_device() == torch.device("cpu")
    assert port_device.select_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.select_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["--bams", "x.bam", "--fasta", "g.fa", "--regions",
                   "r.bed", "--tr-vcf", "out.vcf.gz"], device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        port_device.select_device("meta")
