"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``ddr_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``build/kernels/lib<name>-<digest>.so`` at the
root of the checkout (``<digest>`` hashes the source and the flags, so an
edited kernel is rebuilt and a stale library is never loaded). Nothing here
runs at import time: this module is imported only by a wrapper about to
launch a kernel, or by :func:`build` when a caller wants every kernel ready.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build", "build_dir", "load"]

#: Every kernel source of the port, by name (``csrc/<name>.cu``).
KERNELS = ("wave_scan",)

#: ``sm_90a`` keeps Hopper's arch-specific instructions available; no
#: ``--use_fast_math`` (the physics uses ``powf``); ``--fmad=false`` keeps
#: every multiply and add rounded on its own, as in the plain PyTorch version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (git-ignored)."""
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, build_dir() / f"lib{name}-{digest}.so"


def build(names: tuple[str, ...] = KERNELS, verbose: bool = False) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (0.0
    for a library already on disk); raises with ``nvcc``'s output if one
    fails. ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills per kernel)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    seconds = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(log, end="" if log.endswith("\n") else "\n")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _loaded[name] = lib
        return lib
