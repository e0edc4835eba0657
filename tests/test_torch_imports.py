"""The port stands alone: importing every ``ddr_tpu_torch`` module, and
``chip_smoke.py``, pulls in neither ``jax`` nor any module of ``ddr_tpu``."""

from __future__ import annotations

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import ddr_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import ddr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ddr_tpu_torch.__path__, "ddr_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ddr_tpu" or m.startswith("ddr_tpu."))
print(len(mods), bad)
"""


def test_port_imports_no_jax_and_nothing_of_ddr_tpu():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split("\n")[-2]
    n_mods, bad = out.split(" ", 1)
    names = {m.name for m in pkgutil.walk_packages(ddr_tpu_torch.__path__, "ddr_tpu_torch.")}
    expected = len(names)
    assert int(n_mods) == expected and expected >= 25
    # the stacked band router's and the health plane's modules are among
    # those the probe imported
    assert {"ddr_tpu_torch.routing.chunked", "ddr_tpu_torch.routing.stacked",
            "ddr_tpu_torch.observability", "ddr_tpu_torch.observability.health",
            "ddr_tpu_torch.observability.recovery"} <= names
    assert bad == "[]", f"the port imported {bad}"
