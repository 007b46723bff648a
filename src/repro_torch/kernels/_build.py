"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (loaded with ``ctypes``; no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/kernels/`` at the repository root,
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("simplex_tile", "hyperbox", "revised_tile", "pdhg_tile",
           "ssm_scan")
# sm_90a: Hopper.  -fmad=false keeps nvcc from contracting a*b+c on its
# own; the sources request every fused multiply-add explicitly.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def source(name: str, src=None) -> Path:
    """The source of library ``name``: ``csrc/<name>.cu``, or ``src``."""
    return CSRC / f"{name}.cu" if src is None else Path(src)


def library_path(name: str, extra=(), src=None) -> Path:
    """Where library ``name`` built from ``source(name, src)`` with the
    extra nvcc flags ``extra`` lands."""
    flags = " ".join(NVCC_FLAGS + tuple(extra)).encode()
    digest = hashlib.sha256(source(name, src).read_bytes() + flags)
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES, extra=(), src=None) -> dict:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together, with the extra flags ``extra`` (and
    from ``src`` instead of csrc/, for one name).  Returns ``{name:
    seconds}`` for the ones compiled; raises with nvcc's output when one
    fails.  The compiler report (-Xptxas -v) is kept beside each library as
    ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, extra, src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(source(name, src))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return took


@functools.cache
def load(name: str, extra=(), src=None) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed), with the
    extra nvcc flags ``extra`` and from ``src`` where given."""
    build((name,), extra, src)
    return ctypes.CDLL(str(library_path(name, extra, src)))
