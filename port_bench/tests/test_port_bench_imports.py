"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole, so longtr_tpu_torch is not taken for longtr_tpu)."""

import ast
import glob
import os
import subprocess
import sys

from _paths import HARNESS, ROOT
from pbench import runner

JAX = {"jax", "jaxlib", "flax", "longtr_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*parts):
    return sorted(glob.glob(os.path.join(HARNESS, *parts), recursive=True))


def test_no_source_imports_jax_or_the_jax_package():
    files = [f for f in _sources("**", "*.py")
             if os.sep + "tests" + os.sep not in f]
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & JAX, f


def test_reference_imports_nothing_of_the_program():
    files = _sources("pbref", "*.py")
    assert files
    for f in files:
        tops = set(_imports(f))
        assert "longtr_tpu_torch" not in tops and not tops & JAX, f
        assert tops <= {"__future__", "math", "numpy", "torch"}, (f, tops)


def test_the_check_for_loaded_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "longtr_tpu_torch_x", sys)
    assert runner.forbidden_modules() == [] or all(
        m.split(".")[0] in JAX for m in runner.forbidden_modules())
    monkeypatch.setitem(sys.modules, "longtr_tpu.ops", sys)
    assert "longtr_tpu.ops" in runner.forbidden_modules()
    assert "longtr_tpu_torch_x" not in runner.forbidden_modules()


def test_harness_and_program_import_with_jax_refused():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'longtr_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.path[:0] = [{HARNESS!r}, {ROOT!r}]\n"
            "import pbench.runner, pbench.check, pbench.control, pbench.trace\n"
            "import longtr_tpu_torch.cli, longtr_tpu_torch.pipeline.processor\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, LONGTR_TORCH_DEVICE="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
