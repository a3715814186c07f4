"""The port's import boundary: repro_torch and chip_smoke.py load neither JAX
nor any module of the JAX package, and the package calls no library
attention, torch.compile or Triton."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def _modules():
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        [str(PACKAGE)], "repro_torch.")]


def test_package_and_chip_smoke_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "src"), str(REPO)],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.splitlines()[-2:]
    assert int(count) == len(_modules()) >= 15
    assert bad == "", f"imported: {bad}"


@pytest.mark.parametrize("pattern", [r"scaled_dot_product_attention",
                                     r"torch\.compile", r"\bimport\s+triton",
                                     r"\b(from|import)\s+jax\b",
                                     r"\b(from|import)\s+repro\b(?!_)"])
def test_package_sources_avoid(pattern):
    hits = [str(p.relative_to(REPO)) for p in sorted(PACKAGE.rglob("*"))
            if p.suffix in (".py", ".cu", ".cuh") and re.search(pattern, p.read_text())]
    assert hits == [], f"{pattern!r} in {hits}"
