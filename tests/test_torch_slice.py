"""`longtr` runs through the PyTorch port, on the CPU.

longtr_tpu_torch.cli.main must write VCF bodies byte-identical to
longtr_tpu.cli.main (excluding the ##command line) on the surfaces of
__graft_entry__._dryrun_catalog (core, haploid, --snp-vcf, --ref-vcf, mode
B with --haploid-chrs, LONGTR_DEVICE_POSTERIOR=1), on the tests/synth.py
fixture of tests/test_e2e_pipeline.py (with and without --ref-fidelity;
--snp-vcf with --fam) and on the homopolymer catalog of tests/test_mode_b.py
(mode B: parallel and serial builds, --ref-fidelity).  The port must import
and run with JAX absent, --workers included, and refuse a CUDA device that
is not there.
"""

import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth import (Locus, make_genome, standard_fixture, write_bed,  # noqa: E402
                   write_sample_bam)

from longtr_tpu.cli import main as jax_main  # noqa: E402
from longtr_tpu.io.fasta import write_fasta  # noqa: E402
from longtr_tpu_torch import device as port_device  # noqa: E402
from longtr_tpu_torch.cli import main as port_main  # noqa: E402
from longtr_tpu_torch.ops.mode_b_device import mode_b_elements_scored  # noqa: E402
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


@pytest.fixture(scope="module")
def homopolymers(tmp_path_factory):
    """tests/test_mode_b.py's 8-locus T-homopolymer catalog, one sample."""
    tmp = tmp_path_factory.mktemp("homopolymers")
    rng = np.random.default_rng(17)
    loci = [Locus("chr1", 1000 + 400 * i, "T", 11 + (i % 5), f"HOMO{i}")
            for i in range(8)]
    genome = make_genome(rng, loci)
    fasta = str(tmp / "g.fa")
    write_fasta(fasta, genome)
    bed = str(tmp / "r.bed")
    write_bed(bed, loci)
    genotypes = {l.name: (l.ref_copies, l.ref_copies + (2 if i % 2 else 0))
                 for i, l in enumerate(loci)}
    bam = str(tmp / "S1.bam")
    write_sample_bam(bam, genome, loci, genotypes, "S1", rng, coverage=20)
    return dict(bams=[bam], fasta=fasta, bed=bed, loci=loci)


def _argv(fx, out, extra=()):
    return ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--tr-vcf", out, "--min-reads", "5",
            "--quiet", *extra]


def _reset_ref_fidelity():
    """Each package keeps its own --ref-fidelity flag, and each CLI sets
    its own: reset both."""
    from longtr_tpu.utils import mathops as jax_mathops
    from longtr_tpu_torch.utils import mathops
    jax_mathops.set_ref_fidelity(False)
    mathops.set_ref_fidelity(False)


def _moved(counts, before):
    return {k: counts[k] - before[k] for k in counts}


def _both(fx, tmp_path, extra, route, mode_b_route=None):
    """VCF bodies of the JAX package and of the port on one input; the
    port's pairs must all have gone through `route`, and its mode-B
    elements (if `mode_b_route` is given, else none) through
    `mode_b_route`."""
    out_jax = str(tmp_path / "jax.vcf.gz")
    out_port = str(tmp_path / "port.vcf.gz")
    assert jax_main(_argv(fx, out_jax, extra)) == 0
    before = dict(pairs_scored), dict(mode_b_elements_scored)
    assert port_main(_argv(fx, out_port, extra),
                     device=torch.device("cpu")) == 0
    moved = _moved(pairs_scored, before[0])
    if route is None:
        assert sum(moved.values()) == 0, moved
    else:
        assert moved[route] > 0 and sum(moved.values()) == moved[route], moved
    moved = _moved(mode_b_elements_scored, before[1])
    if mode_b_route is None:
        assert sum(moved.values()) == 0, moved
    else:
        assert moved[mode_b_route] > 0, moved
        assert sum(moved.values()) == moved[mode_b_route], moved
    return body(out_jax), body(out_port)


@pytest.mark.parametrize("extra,route", [([], "cpu"),
                                         (["--ref-fidelity"], "host_f64"),
                                         (["--phased-bam"], "cpu")],
                         ids=["default", "ref_fidelity", "phased_bam"])
def test_synth_fixture_vcf_identical(synth, tmp_path, extra, route):
    try:
        want, got = _both(synth, tmp_path, extra, route)
    finally:
        _reset_ref_fidelity()
    assert sum(1 for ln in want if not ln.startswith("#")) == len(synth["loci"])
    assert got == want


SURFACES = {"core": [], "haploid": ["--haploid-chrs", "chrH"],
            "snp_vcf": ["--snp-vcf", "{snp_vcf}"],
            "ref_vcf": ["--ref-vcf", "{panel}"],
            "mode_b_haploid": ["--stutter-align-len", "25",
                               "--haploid-chrs", "chrH"]}


@pytest.mark.parametrize("surface", list(SURFACES))
def test_dryrun_surface_vcf_identical(dryrun, tmp_path, surface):
    """The surfaces of the dryrun catalog; mode B scores its homopolymers
    on the plain rows and the other loci as pairs."""
    extra = [a.format(**dryrun) for a in SURFACES[surface]]
    want, got = _both(dryrun, tmp_path, ["--use-unpaired", *extra], "cpu",
                      "cpu" if surface == "mode_b_haploid" else None)
    assert sum(1 for ln in want if not ln.startswith("#")) > 10
    assert got == want


def test_device_posterior_vcf_identical(dryrun, tmp_path, monkeypatch):
    """LONGTR_DEVICE_POSTERIOR=1 (the window's pruning decision from one
    batched posterior call) writes longtr_tpu's body, which is also the
    port's default body."""
    default = str(tmp_path / "default.vcf.gz")
    assert port_main(_argv(dryrun, default, ["--use-unpaired"]),
                     device="cpu") == 0
    monkeypatch.setenv("LONGTR_DEVICE_POSTERIOR", "1")
    want, got = _both(dryrun, tmp_path, ["--use-unpaired"], "cpu")
    assert sum(1 for ln in want if not ln.startswith("#")) > 10
    assert got == want == body(default)


@pytest.mark.parametrize("serial", [False, True], ids=["parallel", "serial"])
def test_mode_b_homopolymers_vcf_identical(homopolymers, tmp_path,
                                           monkeypatch, serial):
    """Mode B on every locus of a homopolymer catalog, with the builds on
    the thread pool or inline (LONGTR_SERIAL_BUILD=1)."""
    if serial:
        monkeypatch.setenv("LONGTR_SERIAL_BUILD", "1")
    want, got = _both(homopolymers, tmp_path, ["--stutter-align-len", "25"],
                      None, "cpu")
    assert sum(1 for ln in want if not ln.startswith("#")) == 8
    assert got == want


def test_mode_b_ref_fidelity_vcf_identical(homopolymers, tmp_path):
    """--ref-fidelity scores every mode-B element on the host in f64."""
    try:
        want, got = _both(homopolymers, tmp_path,
                          ["--stutter-align-len", "25", "--ref-fidelity"],
                          None, "host_f64")
    finally:
        _reset_ref_fidelity()
    assert sum(1 for ln in want if not ln.startswith("#")) == 8
    assert got == want


def test_snp_vcf_fam_vcf_identical(tmp_path):
    """--snp-vcf with --fam (pedigree SNP filtering) on the synth fixture of
    tests/test_snp_phasing.py; --fam without --snp-vcf exits."""
    from test_snp_phasing import write_snp_vcf
    rng = np.random.default_rng(33)
    fx = standard_fixture(str(tmp_path), rng=rng)
    snps = str(tmp_path / "snps.vcf.gz")
    write_snp_vcf(snps, fx["genome"], ["SAMP1", "SAMP2", "SAMP3"], rng,
                  chroms=("chr1", "chr2", "chr3"))
    fam = str(tmp_path / "trio.fam")
    with open(fam, "w") as fh:
        fh.write("FAM1\tSAMP1\tSAMP2\tSAMP3\n")
    want, got = _both(fx, tmp_path, ["--snp-vcf", snps, "--fam", fam], "cpu")
    assert sum(1 for ln in want if not ln.startswith("#")) == len(fx["loci"])
    assert any(";DSNP=0;" in ln for ln in want)
    assert got == want
    with pytest.raises(SystemExit, match="--fam option only applies"):
        port_main(_argv(fx, str(tmp_path / "x.vcf.gz"), ["--fam", fam]),
                  device="cpu")


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


def test_imports_and_runs_without_jax(synth, homopolymers, tmp_path):
    """In a fresh interpreter where `import jax` fails, every module of the
    port (the mesh included) imports and its CLI genotypes the synth
    fixture, the homopolymer catalog in mode B, and the synth fixture again
    with --workers 2."""
    runs = [(synth, str(tmp_path / "nojax.vcf.gz"), []),
            (homopolymers, str(tmp_path / "nojax_mode_b.vcf.gz"),
             ["--stutter-align-len", "25"])]
    workers = _argv(synth, str(tmp_path / "nojax_workers.vcf.gz"),
                    ["--workers", "2"])
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import longtr_tpu_torch
        for m in pkgutil.walk_packages(longtr_tpu_torch.__path__,
                                       "longtr_tpu_torch."):
            importlib.import_module(m.name)
        import longtr_tpu_torch.parallel.mesh
        from longtr_tpu_torch.cli import main
        for argv in {[_argv(fx, out, extra) for fx, out, extra in runs]!r}:
            assert main(argv, device="cpu") == 0
        assert main({workers!r}) == 0
        assert "jax" not in [k.split(".")[0] for k, v in sys.modules.items()
                             if v is not None]
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for k, (fx, out, extra) in enumerate(runs):
        want = str(tmp_path / f"jax{k}.vcf.gz")
        assert jax_main(_argv(fx, want, extra)) == 0
        assert body(out) == body(want)
    assert body(workers[workers.index("--tr-vcf") + 1]) == body(
        str(tmp_path / "jax0.vcf.gz"))


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
