"""repro_torch stands alone: it imports neither jax nor any repro module."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
                       r"|from\s+repro(\.|\s)(?!_))", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len([m for m in sys.modules if m.startswith("repro_torch")]), bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15    # every module was imported


def test_sources_have_no_jax_or_repro_imports():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x\n")
    assert FORBIDDEN.search("import jax.numpy as jnp\n")
    assert not FORBIDDEN.search("from repro_torch.core import x\n")


def test_convert_round_trip_and_device_check():
    arrays = {"a": np.arange(6.0).reshape(2, 3), "b": [np.ones(2, np.int32)]}
    back = convert.to_numpy(convert.from_numpy(arrays, device="cpu"))
    np.testing.assert_array_equal(back["a"], arrays["a"])
    np.testing.assert_array_equal(back["b"][0], arrays["b"][0])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_numpy(arrays["a"])
