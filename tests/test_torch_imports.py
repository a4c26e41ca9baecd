"""Import guard for the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of the JAX package
``repro`` (the port keeps its own copies of what it needs).  An AST walk in
the manner of ``scripts/check_obs_imports.py``: every ``import`` and
``from ... import`` is checked, including relative imports that climb out
of the package."""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


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
                 "kernels/chunk_agg.py", "kernels/round_stats.py"):
        assert must in names


@pytest.mark.parametrize(
    "path,depth", _port_modules() + [(os.path.join(ROOT, "chip_smoke.py"), -1)],
    ids=lambda v: os.path.relpath(v, ROOT) if isinstance(v, str) else None)
def test_no_jax_or_repro_imports(path, depth):
    assert violations_in(path, depth) == []


def test_guard_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import engine\n"
                   "from repro_torch.core import engine as ok\n"
                   "from ... import x\n")
    found = [msg for _, msg in violations_in(str(src), 1)]
    assert found == ["import jax.numpy", "from repro.core import ...",
                     "from ... import ... (climbs out of repro_torch)"]
