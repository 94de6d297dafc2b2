"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``<repo>/.torch_ext/<name>-<digest>.so`` at
first use and loaded with ``ctypes``; the digest covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source rebuilds
and an unchanged one is reused.
``build`` starts one ``nvcc`` per source, all at once, and waits for all.
Nothing here runs at import: the package imports on machines without a
CUDA toolkit, where only the kernels' plain twins can run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

__all__ = ["build", "library", "log_path", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (set CUDA_HOME); the port's CUDA "
                         "kernels are built from source at first use")
    return found


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name) -> Path:
    """Where the compiler's output (``-Xptxas -v``) of ``name`` is kept."""
    return _target(name)[1].with_suffix(".log")


def build(names):
    """Compile every named source that is not built yet, in parallel;
    returns {name: path of the shared library}."""
    running = []
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, so))
    failed = []
    for name, proc, tmp, so in running:
        try:
            out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {_NVCC_TIMEOUT_S} s"
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out[-6000:]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return {name: _target(name)[1] for name in names}


def library(name):
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
