"""Import guard for the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of the JAX package
``repro`` (the port keeps its own copies of what it needs), nor
``msgpack``, which the GPU machine lacks (the port's checkpoints write a
JSON manifest).  An AST walk in
the manner of ``scripts/check_obs_imports.py``: every ``import`` and
``from ... import`` is checked, including relative imports that climb out
of the package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack")


def violations_in(path: str, package_depth: int) -> list[tuple[int, str]]:
    """``package_depth``: how many packages deep the module sits below
    ``repro_torch`` (0 for the package's top level, -1 outside it)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, f"import {a.name}") for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level > 0 and node.level > package_depth + 1:
                bad.append((node.lineno, "from " + "." * node.level
                            + " import ... (climbs out of repro_torch)"))
            elif node.level == 0 and _forbidden(node.module or ""):
                bad.append((node.lineno, f"from {node.module} import ..."))
    return bad


def _port_modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        rel = os.path.relpath(dirpath, PKG)
        depth = 0 if rel == "." else rel.count(os.sep) + 1
        out += [(os.path.join(dirpath, f), depth) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def test_port_has_modules():
    names = {os.path.relpath(p, PKG) for p, _ in _port_modules()}
    for must in ("core/engine.py", "kernels/slot_extract.py",
                 "serve/ola_server.py", "sampling/permutation.py",
                 "core/groupby.py", "kernels/slot_extract_grouped.py",
                 "kernels/chunk_agg.py", "kernels/round_stats.py",
                 "train/optimizer.py", "train/train_step.py",
                 "train/checkpoint.py", "train/trainer.py",
                 "distributed/fault.py", "distributed/compression.py",
                 "distributed/sharding.py", "distributed/autoshard.py",
                 "distributed/layout.py", "launch/mesh.py",
                 "launch/steps.py", "launch/verify_cell.py",
                 "launch/dryrun.py", "roofline/hw.py",
                 "roofline/analysis.py", "roofline/dispatch_walk.py",
                 "examples/train_with_verification.py", "tree.py"):
        assert must in names


def test_lower_layers_do_not_import_train():
    """The models and gradient compression sit below the training plane:
    importing them loads nothing of ``repro_torch.train``."""
    code = ("import sys, repro_torch.models, repro_torch.distributed; "
            "print([m for m in sys.modules "
            "if m.startswith('repro_torch.train')])")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize(
    "path,depth", _port_modules() + [(os.path.join(ROOT, "chip_smoke.py"), -1)],
    ids=lambda v: os.path.relpath(v, ROOT) if isinstance(v, str) else None)
def test_no_jax_or_repro_imports(path, depth):
    assert violations_in(path, depth) == []


def test_guard_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import engine\n"
                   "from repro_torch.core import engine as ok\n"
                   "from ... import x\nimport msgpack\n")
    found = [msg for _, msg in violations_in(str(src), 1)]
    assert found == ["import jax.numpy", "from repro.core import ...",
                     "from ... import ... (climbs out of repro_torch)",
                     "import msgpack"]
