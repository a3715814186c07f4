"""Builds a kernel source under ``csrc/`` with ``nvcc`` at first use.

Every kernel of the port is one ``.cu`` file with a plain C interface,
compiled into a shared library and loaded with ``ctypes`` by ``load``, which
each kernel's wrapper calls with the C signatures of its source.  The library goes
to ``build/kernels/`` at the repository root, named by the source's stem and a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  A build writes a temporary file and
renames it into place, so concurrent builds of one source publish the same
file.  Nothing here runs when the module is imported: the CPU tests import it
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float     # 0.0 when an earlier build of the same source was reused
    log: str           # nvcc's output (ptxas registers and spills); "" if reused

    def ptxas_lines(self) -> list:
        """ptxas's per-kernel register, shared-memory and spill lines."""
        return [ln.strip() for ln in self.log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


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


def library_path(source: Path) -> Path:
    """Where the library of ``source`` goes: ``<stem>-<hash>.so``."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Built:
    """Compile ``source`` into a shared library unless it was built already."""
    out = library_path(source)
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent build publishes the same file
    return Built(out, seconds, proc.stdout + proc.stderr)


_LOADED: dict = {}


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """The library of ``source``, built first if needed and loaded once per
    process.  ``signatures`` maps each C function to ``(restype, argtypes)``."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source).path))
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LOADED[source] = lib
    return lib
