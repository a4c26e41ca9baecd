"""What the benchmark runs never loads JAX or the JAX package ``repro``
(compared by whole top-level names: the port's own name begins with the
latter's), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources(sub=""):
    base = os.path.join(spec.HERE, sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_source_imports_jax_or_repro(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "typing", "math", "torch", "numpy"}
    assert set(_imports(path)) <= allowed


def test_a_run_loads_no_jax_or_repro():
    """A small run on the CPU, in a fresh interpreter, then the modules it
    holds, the way run.py looks after its window."""
    code = f"""
import sys, time
sys.path[:0] = [{spec.HERE!r}, {os.path.join(spec.ROOT, 'src')!r}]
import run
from harness import cell as c, spec
cell = spec.cell(spec.load(), "zipf16-packed.adhoc")
cell.config = spec.read_config("zipf16-files")
cell.config["table"].update(num_tuples=16 * 512, num_chunks=16)
cell.traffic.update(drain_s=5, warmup_steps=5)
c.run(cell, 3, 0.0, True, "cpu", time.perf_counter(), window_steps=20)
print(sorted(run.forbidden_modules()), "repro_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
