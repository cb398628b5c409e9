"""The port's CLI with a mesh and its multi-process and profiling options.

* The five surfaces of ``__graft_entry__.dryrun_multichip`` (core,
  snp-vcf, mode-b+haploid, ref-vcf, em-training) through
  ``longtr_tpu_torch.cli.main(..., mesh=8 x cpu)``: each VCF body equals
  the port's meshless run and ``longtr_tpu``'s run under
  ``LONGTR_FORCE_MESH=1``.
* ``--workers 2`` and a two-process ``--distributed`` run (gloo on
  localhost) write the single run's VCF body and leave no shard files;
  each runs under a time limit, so a hung process cannot stall the suite.
* ``--jax-profile DIR`` writes a readable ``torch.profiler`` trace.
* Every console script of pyproject.toml imports with JAX absent.
"""

import glob
import gzip
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import tomllib

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth import standard_fixture, vcf_body  # noqa: E402

from longtr_tpu.cli import main as jax_main  # noqa: E402
from longtr_tpu_torch.cli import main as port_main  # noqa: E402
from longtr_tpu_torch.ops.pairhmm import pairs_scored  # noqa: E402
from longtr_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def body(path):
    with gzip.open(path, "rt") as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith("##command")]


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    sys.path.insert(0, REPO)
    from __graft_entry__ import _dryrun_catalog
    return _dryrun_catalog(str(tmp_path_factory.mktemp("dryrun")))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return standard_fixture(str(tmp_path_factory.mktemp("synth")))


def _argv(fx, out, extra=()):
    return ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--tr-vcf", out, "--min-reads", "5",
            "--quiet", *extra]


# __graft_entry__.dryrun_multichip's surfaces
MESH_SURFACES = {"core": [], "snp-vcf": ["--snp-vcf", "{snp_vcf}"],
                 "mode-b+haploid": ["--stutter-align-len", "25",
                                    "--haploid-chrs", "chrH"],
                 "ref-vcf": ["--ref-vcf", "{panel}"],
                 "em-training": ["--no-def-stutter-model"]}


@pytest.mark.parametrize("surface", list(MESH_SURFACES))
def test_mesh_surface_vcf_identical(dryrun, tmp_path, monkeypatch, surface):
    extra = ["--use-unpaired",
             *(a.format(**dryrun) for a in MESH_SURFACES[surface])]
    plain = str(tmp_path / "plain.vcf.gz")
    assert port_main(_argv(dryrun, plain, extra), device=CPU) == 0
    meshed = str(tmp_path / "mesh.vcf.gz")
    scored, trains = dict(pairs_scored), port_mesh.em_trains["cpu"]
    assert port_main(_argv(dryrun, meshed, extra), device=CPU,
                     mesh=port_mesh.Mesh([CPU] * 8)) == 0
    moved = {k: pairs_scored[k] - scored[k] for k in pairs_scored}
    assert moved["cpu"] > 0 and sum(moved.values()) == moved["cpu"], moved
    if surface == "em-training":
        assert port_mesh.em_trains["cpu"] > trains
    want = str(tmp_path / "jax_mesh.vcf.gz")
    monkeypatch.setenv("LONGTR_FORCE_MESH", "1")
    assert jax_main(_argv(dryrun, want, extra)) == 0
    assert sum(1 for ln in body(want) if not ln.startswith("#")) > 10
    assert body(meshed) == body(plain) == body(want)


def _kill_group(procs):
    for pr in procs:
        if pr.poll() is None:
            os.killpg(pr.pid, signal.SIGKILL)
            pr.wait()


def _run_port(argvs, timeout):
    """Run `python -m longtr_tpu_torch.cli` once per argv, all at once,
    each in its own process group; kill every group left at the time
    limit.  Returns [(returncode, stderr)]."""
    procs = [subprocess.Popen([sys.executable, "-m", "longtr_tpu_torch.cli",
                               *argv], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, start_new_session=True)
             for argv in argvs]
    try:
        outs = [pr.communicate(timeout=timeout) for pr in procs]
    finally:
        _kill_group(procs)
    return [(pr.returncode, err.decode()[-3000:])
            for pr, (_o, err) in zip(procs, outs)]


def test_workers_mode_matches_single_run(synth, tmp_path):
    """Port of test_sharding.test_workers_mode_matches_single_run: `--workers
    2` reproduces the single run's VCF body, merges --pass-bam (given in
    the `=` form) and the metrics, and leaves no shard files behind."""
    base = ["--bams", ",".join(synth["bams"]), "--fasta", synth["fasta"],
            "--regions", synth["bed"], "--min-reads", "5", "--quiet"]
    whole = str(tmp_path / "whole.vcf.gz")
    metrics1 = str(tmp_path / "metrics1.json")
    pass1 = str(tmp_path / "pass1.bam")
    assert port_main(base + ["--tr-vcf", whole, "--pass-bam", pass1,
                             "--metrics-out", metrics1], device=CPU) == 0
    multi = str(tmp_path / "multi.vcf.gz")
    metrics = str(tmp_path / "metrics.json")
    passn = str(tmp_path / "passn.bam")
    [(rc, err)] = _run_port([base + ["--tr-vcf", multi, "--workers", "2",
                                     f"--pass-bam={passn}",
                                     "--metrics-out", metrics]], timeout=300)
    assert rc == 0, err
    assert vcf_body(multi) == vcf_body(whole)
    assert os.path.exists(multi + ".tbi")
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]

    def bam_keys(path):
        from longtr_tpu.io.bam import BamReader
        r = BamReader(path)
        out = []
        while (rec := r.get_next_alignment()) is not None:
            out.append((rec.name, rec.ref_id, rec.pos))
        return out

    got, want = bam_keys(passn), bam_keys(pass1)
    assert sorted(got) == sorted(want) and len(got) > 0
    assert got == sorted(got, key=lambda k: (k[1], k[2]))
    with open(metrics) as fh:
        m = json.load(fh)
    with open(metrics1) as fh:
        m1 = json.load(fh)
    for key in ("loci_processed", "num_genotype_success"):
        assert m[key] == m1[key]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_distributed_two_process_matches_single(synth, tmp_path):
    """Port of tests/test_distributed.py: two processes in a gloo process
    group on localhost, each on its block shard; rank 0 merges after the
    barrier."""
    base = ["--bams", ",".join(synth["bams"]), "--fasta", synth["fasta"],
            "--regions", synth["bed"], "--min-reads", "5", "--quiet"]
    whole = str(tmp_path / "whole.vcf.gz")
    stutter1 = str(tmp_path / "stutter1.txt")
    assert port_main(base + ["--tr-vcf", whole, "--stutter-out", stutter1],
                     device=CPU) == 0
    multi = str(tmp_path / "multi.vcf.gz")
    stuttern = str(tmp_path / "stuttern.txt")
    port = _free_port()
    results = _run_port(
        [base + ["--tr-vcf", multi, "--stutter-out", stuttern,
                 "--distributed", "--coordinator", f"localhost:{port}",
                 "--num-processes", "2", "--process-id", str(i)]
         for i in range(2)], timeout=300)
    for rc, err in results:
        assert rc == 0, err
    assert vcf_body(multi) == vcf_body(whole)
    assert os.path.exists(multi + ".tbi")
    assert open(stuttern).read() == open(stutter1).read()
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]


def test_distributed_without_rendezvous_exits(synth, tmp_path, monkeypatch):
    """`--distributed` with neither --coordinator nor torchrun's variables
    fails; it does not run unsharded."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    out = str(tmp_path / "x.vcf.gz")
    with pytest.raises(SystemExit, match="process group did not start"):
        port_main(_argv(synth, out, ["--distributed"]), device=CPU)
    assert not os.path.exists(out)


def test_profile_writes_a_trace(synth, tmp_path):
    prof = str(tmp_path / "prof")
    out = str(tmp_path / "p.vcf.gz")
    assert port_main(_argv(synth, out, ["--jax-profile", prof]),
                     device=CPU) == 0
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert sum(1 for ln in body(out) if not ln.startswith("#")) > 0


def _console_scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)["project"]["scripts"]


@pytest.mark.parametrize("script", sorted(_console_scripts()))
def test_console_script_imports_without_jax(script):
    """Every console script's module imports, and its entry point exists,
    in an interpreter where `import jax` fails: none needs a port."""
    module, func = _console_scripts()[script].split(":")
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        m = importlib.import_module({module!r})
        assert callable(getattr(m, {func!r}))
        assert "jax" not in [k.split(".")[0] for k, v in sys.modules.items()
                             if v is not None]
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
