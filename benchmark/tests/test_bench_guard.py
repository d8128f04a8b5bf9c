"""The import guard, and the reference's independence from the program."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

from benchmark.harness import guard


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert guard.forbidden_loaded(["quickrank_tpu.ops", "flax"]) == ["flax", "quickrank_tpu"]
    assert guard.forbidden_loaded(["quickrank_tpu_torch", "quickrank_tpu_torch.ops",
                                   "jaxtyping", "jaxlibx"]) == []


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.harness.runner, benchmark.harness.program, benchmark.control; "
            "from benchmark.harness import guard; print(guard.forbidden_loaded())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            mods = set(_imports(os.path.join(ref, f)))
            assert not mods & {"quickrank_tpu_torch", "quickrank_tpu", "jax", "benchmark"}, f


def test_only_program_module_imports_the_program():
    bench = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(bench):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath:
                mods = set(_imports(os.path.join(dirpath, f)))
                assert "jax" not in mods and "quickrank_tpu" not in mods, f
                if "quickrank_tpu_torch" in mods:
                    assert f == "program.py", f
