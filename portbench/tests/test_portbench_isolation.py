"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole), and the reference imports nothing of
the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT
from portbench import harness

PORTBENCH = os.path.join(ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_check_compares_whole_top_level_names(monkeypatch):
    for name in ("clipspm_tpu_torch", "clipspm_tpu_torch.ops",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "clipspm_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["clipspm_tpu", "jax"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(PORTBENCH, "**", "*.py"),
                          recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(PORTBENCH, "reference", "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "clipspm_tpu_torch" not in tops, path
        assert "portbench" not in tops, path


def test_loading_the_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.run, portbench.reference.precision\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'clipspm_tpu_torch', 'clipspm_tpu', 'jax', 'jaxlib', 'flax'})\n"
            "print(bad)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_a_run_loads_no_jax(tmp_path):
    """The harness with the program loaded, in a fresh process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, program, compare, trace\n"
            "from portbench.entries import evaluate, train_episodes\n"
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
