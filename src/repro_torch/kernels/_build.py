"""Build and load the package's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes).  Libraries land in ``build/repro_torch/``
at the root of the checkout (``$REPRO_TORCH_BUILD_DIR`` overrides it), named
by a hash of the source, the headers it includes and the flags, so an edited
source or header rebuilds and an unchanged one is loaded as it is.  Nothing is built at import: the first
call that needs a kernel builds it, and :func:`build_all` builds every
source at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) and
#: wall seconds of each build this process ran, by source name.
BUILD_LOG: dict[str, dict] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or $CUDA_HOME/bin)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _closure(path: Path, seen: dict) -> None:
    """``path`` and, recursively, every file it includes with ``#include
    "..."`` (resolved beside the including file), into ``seen``."""
    if path in seen:
        return
    text = path.read_bytes()
    seen[path] = text
    for inc in _INCLUDE.findall(text):
        dep = path.parent / inc.decode()
        if not dep.exists():
            raise FileNotFoundError(f"{path.name} includes missing {dep}")
        _closure(dep, seen)


def _target(name: str) -> Path:
    """The library path of ``csrc/<name>.cu``: named by a hash of the source,
    every header it includes, and the flags, so editing any of them
    rebuilds."""
    files: dict = {}
    _closure(CSRC / f"{name}.cu", files)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(files):
        h.update(path.name.encode() + b"\0" + files[path])
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None) -> dict[str, float]:
    """Build every (or the named) source that has no library for its
    current hash yet, one ``nvcc`` per source, all running at once.
    Returns the wall seconds each build took (0.0 for an up-to-date one);
    raises with ``nvcc``'s output when a build fails."""
    names = sources() if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            secs[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = {"seconds": secs[name], "nvcc": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all([name])
            lib = _LIBS[name] = ctypes.CDLL(str(target))
        return lib
