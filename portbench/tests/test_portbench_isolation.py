"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program it judges."""

import ast
import json
import os
import subprocess
import sys

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "libultrahdr_dev_tpu"}
PORT = "libultrahdr_dev_tpu_torch"


def _sources(*parts):
    base = os.path.join(HERE, *parts)
    if base.endswith(".py"):
        return [base]
    return [os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs
            if f.endswith(".py") and "tests" not in d.split(os.sep)]


def _imported(path):
    """Top-level names of every absolute import of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _loaded(modules):
    """Top-level names of sys.modules after importing `modules` in a
    fresh interpreter."""
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in list(sys.modules)})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        assert not _imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (_sources("reference") + _sources("judge.py")
                 + _sources("roofline.py") + _sources("content.py")):
        names = _imported(path)
        assert PORT not in names and not names & FORBIDDEN, path


def test_the_whole_name_is_compared():
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    assert "libultrahdr_dev_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    readers = [f"portbench.{d}.{n[:-3]}" for d in ("metrics", "entries")
               for n in sorted(os.listdir(os.path.join(HERE, d)))
               if n.endswith(".py") and n != "__init__.py"]
    loaded = _loaded(["portbench.harness", "portbench.control",
                      "portbench.check_trace", "portbench.stress"] + readers)
    loaded |= _loaded(["portbench.harness", PORT,
                       PORT + ".parallel.batched", PORT + ".api"])
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(["portbench.reference.jpeg", "portbench.reference.codec",
                      "portbench.reference.writer", "portbench.judge",
                      "portbench.roofline"])
    assert PORT not in loaded and not loaded & FORBIDDEN, loaded
