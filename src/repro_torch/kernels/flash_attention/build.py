"""Builds ``csrc/flash_fwd.cu`` with ``nvcc`` at first use and loads it.

The library goes to ``build/kernels/`` at the repository root, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  Nothing here runs when the module is
imported: the CPU tests import it on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float     # 0.0 when an earlier build of the same source was reused
    log: str           # nvcc's output (ptxas registers and spills); "" if reused


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def build() -> Built:
    """Compile the kernel library unless this source was built already."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"flash_fwd-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent build publishes the same file
    return Built(out, seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                              i32, i32, i32, ctypes.c_float, ptr]
    lib.flash_fwd.restype = i32
    lib.flash_fwd_error_string.argtypes = [i32]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib
