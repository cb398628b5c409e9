"""The port stands alone: it imports nothing of JAX or of the JAX package.

(a) No ``.py`` under ``longtr_tpu_torch/``, nor ``chip_smoke.py``,
    tests/test_torch_cuda.py or tests/_torch_cases.py, imports, at module
    level or inside a function, ``jax``, ``longtr_tpu`` (or a module of
    it), ``__graft_entry__``, ``benchmarks`` or tests/synth.py (read from
    the source's syntax tree).
(b) In a fresh interpreter whose import system refuses ``jax`` and
    ``longtr_tpu*`` (a meta-path finder installed at start-up, which the
    ``--workers`` children inherit through ``PYTHONPATH``), every module of
    the port imports and its CLI genotypes the dryrun catalog's core
    surface, alone and with ``--workers 2``; no refused import is even
    attempted, and the VCF bodies equal the JAX package's run of the same
    inputs in this process.
(c) The port's native library is its own build, under
    ``longtr_tpu_torch/``.
"""

import ast
import gzip
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "longtr_tpu_torch")
FORBIDDEN = ("jax", "longtr_tpu", "__graft_entry__", "benchmarks", "synth")


def _sources():
    out = []
    for dirpath, _dirs, files in os.walk(PORT):
        out += [os.path.relpath(os.path.join(dirpath, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py", "tests/test_torch_cuda.py",
                          "tests/_torch_cases.py"]


def _imported(tree):
    """Top-level names of every module an import statement names."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


@pytest.mark.parametrize("path", _sources())
def test_no_forbidden_import(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    bad = sorted(set(_imported(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_source_scan_covers_the_port():
    """The scan reaches every package of the port, the copied host layers
    and console tools included."""
    dirs = {os.path.dirname(p) for p in _sources()}
    for sub in ("", "io", "haplotype", "native", "utils", "denovo", "scripts",
                "models", "ops", "parallel", "pipeline", "testing"):
        assert os.path.join("longtr_tpu_torch", sub).rstrip("/") in dirs, sub


# Installed at interpreter start: refuses jax and longtr_tpu* and records
# every attempt in $LONGTR_REFUSED_LOG.
SITECUSTOMIZE = '''
import os, sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "longtr_tpu"):
            with open(os.environ["LONGTR_REFUSED_LOG"], "a") as fh:
                fh.write(name + "\\n")
            raise ImportError(f"{name} is refused here")
        return None

sys.meta_path.insert(0, _Refuse())
'''


def _body(path):
    with gzip.open(path, "rt") as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith("##command")]


def test_port_runs_with_jax_package_refused(tmp_path):
    from longtr_tpu.cli import main as jax_main
    from longtr_tpu_torch.testing.catalogs import dryrun_catalog
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    refused = tmp_path / "refused.log"
    refused.write_text("")
    dr = dryrun_catalog(str(tmp_path))
    base = ["--bams", ",".join(dr["bams"]), "--fasta", dr["fasta"],
            "--regions", dr["bed"], "--use-unpaired", "--min-reads", "5",
            "--quiet"]
    one, two = str(tmp_path / "one.vcf.gz"), str(tmp_path / "two.vcf.gz")
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import longtr_tpu_torch
        for m in pkgutil.walk_packages(longtr_tpu_torch.__path__,
                                       "longtr_tpu_torch."):
            importlib.import_module(m.name)
        from longtr_tpu_torch.cli import main
        assert main({base + ["--tr-vcf", one]!r}, device="cpu") == 0
        assert main({base + ["--tr-vcf", two, "--workers", "2"]!r},
                    device="cpu") == 0
        loaded = sorted(k for k, v in sys.modules.items() if v is not None
                        and k.split(".")[0] in ("jax", "longtr_tpu"))
        assert not loaded, loaded
    """)
    env = dict(os.environ, LONGTR_REFUSED_LOG=str(refused),
               PYTHONPATH=os.pathsep.join([str(site), REPO]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert refused.read_text() == ""
    want = str(tmp_path / "jax.vcf.gz")
    assert jax_main(base + ["--tr-vcf", want]) == 0
    records = [ln for ln in _body(want) if not ln.startswith("#")]
    assert len(records) == dr["n_loci"]
    assert _body(one) == _body(want)
    assert _body(two) == _body(want)


def test_native_library_is_the_ports_own():
    from longtr_tpu import native as jax_native
    from longtr_tpu_torch import native
    lib = native.get_lib()
    assert lib is not None, "the port's native library did not build"
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.realpath(PORT) + os.sep), path
    assert os.path.dirname(path) == os.path.realpath(
        os.path.join(PORT, "_build"))
    assert os.path.realpath(jax_native._LIB_PATH) != path
    with open(os.path.join(PORT, "native", "longtr_native.cc"), "rb") as a, \
            open(os.path.join(REPO, "longtr_tpu", "native",
                              "longtr_native.cc"), "rb") as b:
        assert a.read() == b.read()
