"""Builds a kernel source under ``csrc/`` with ``nvcc`` at first use.

Every kernel of the port is one ``.cu`` file with a plain C interface,
compiled into a shared library and loaded with ``ctypes`` by ``load``, which
each kernel's wrapper calls with the C signatures of its source.  The library goes
to ``build/kernels/`` at the repository root, named by the source's stem and a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is, with the compiler's log that was kept
beside it.  ``flags`` adds compiler flags (such as a ``-D`` define) to one
build, which then gets a library of its own.  A build writes a temporary
file and renames it into place, so concurrent builds of one source publish
the same file.  Nothing here runs when the module is imported: the CPU
tests import it on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float     # 0.0 when an earlier build of the same source was reused
    log: str           # nvcc's output (ptxas registers and spills), kept beside the library

    def ptxas_lines(self) -> list:
        """ptxas's per-kernel register, shared-memory and spill lines."""
        return [ln.strip() for ln in self.log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]

    def kernels(self) -> list:
        """One dict per compiled entry function: its (mangled) ``name``,
        ``registers``, ``spill_stores`` and ``spill_loads`` in bytes."""
        out = []
        for line in self.log.splitlines():
            if m := _ENTRY.search(line):
                out.append({"name": m.group(1), "registers": None,
                            "spill_stores": 0, "spill_loads": 0})
            elif out and (m := _SPILL.search(line)):
                out[-1]["spill_stores"], out[-1]["spill_loads"] = map(int, m.groups())
            elif out and (m := _REGS.search(line)):
                out[-1]["registers"] = int(m.group(1))
        return out


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


def library_path(source: Path, flags: tuple = ()) -> Path:
    """Where the library of ``source`` built with ``flags`` goes:
    ``<stem>-<hash>.so``."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path, flags: tuple = ()) -> Built:
    """Compile ``source`` with ``NVCC_FLAGS`` and ``flags`` into a shared
    library unless it was built already."""
    out = library_path(source, flags)
    log_path = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    tmp_log = log_path.with_suffix(f".{os.getpid()}.tmplog")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, out)    # atomic: a concurrent build publishes the same file
    return Built(out, seconds, log)


_LOADED: dict = {}


def load(source: Path, signatures: dict, flags: tuple = ()) -> ctypes.CDLL:
    """The library of ``source`` built with ``flags``, built first if needed
    and loaded once per process.  ``signatures`` maps each C function to
    ``(restype, argtypes)``."""
    lib = _LOADED.get((source, flags))
    if lib is None:
        lib = ctypes.CDLL(str(build(source, flags).path))
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LOADED[(source, flags)] = lib
    return lib
