"""The port stands alone: importing every ``ddr_tpu_torch`` module, and
``chip_smoke.py``, pulls in neither ``jax`` nor any module of ``ddr_tpu``;
and every import statement in them, at any depth of any function, names the
standard library, ``torch``, ``numpy``, ``scipy`` or the port itself. The
card machine has only those, so an import of ``yaml``, ``pydantic``,
``pandas`` or ``matplotlib`` (which this machine has) fails here first."""

from __future__ import annotations

import ast
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
            "ddr_tpu_torch.observability.recovery", "ddr_tpu_torch.cli",
            "ddr_tpu_torch.scripts.train", "ddr_tpu_torch.scripts.common",
            "ddr_tpu_torch.validation.configs", "ddr_tpu_torch.validation.yaml_subset",
            "ddr_tpu_torch.validation.enums", "ddr_tpu_torch.validation.metrics",
            "ddr_tpu_torch.validation.utils", "ddr_tpu_torch.geodatazoo.dataclasses",
            "ddr_tpu_torch.geodatazoo.loader", "ddr_tpu_torch.io.readers",
            "ddr_tpu_torch.io.zarrlite", "ddr_tpu_torch.scripts.test", "ddr_tpu_torch.scripts.router",
            "ddr_tpu_torch.scripts.train_and_test", "ddr_tpu_torch.benchmarks.irf",
            "ddr_tpu_torch.benchmarks.configs", "ddr_tpu_torch.benchmarks.benchmark"} <= names
    assert bad == "[]", f"the port imported {bad}"


ALLOWED = set(sys.stdlib_module_names) | {"torch", "numpy", "scipy", "ddr_tpu_torch"}


def _imported_modules(path: Path) -> list[tuple[int, str]]:
    """(line, top-level module) of every absolute import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
    return out


def test_every_import_statement_names_an_allowed_package():
    files = sorted((ROOT / "ddr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 40
    bad = [f"{path.relative_to(ROOT)}:{line} imports {mod}"
           for path in files for line, mod in _imported_modules(path) if mod not in ALLOWED]
    assert not bad, bad


def test_the_walk_sees_imports_inside_functions(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import yaml\n    from pandas import DataFrame\n")
    assert [m for _, m in _imported_modules(probe)] == ["yaml", "pandas"]
