"""Model registry: named KAN modules with atomic checkpoint hot-reload.

The port's copy of ``ddr_tpu/serving/registry.py``. The JAX registry swaps a
parameter pytree that its compiled program takes as an argument; here an
entry holds the ``Kan`` module itself, and a swap replaces the module:

- :class:`ModelRegistry` maps ``name -> ModelEntry(kan, version, ...)``.
  Reads take one lock-protected snapshot, and a batch holds that entry for
  its whole run, so every request sees the old or the new weights in full,
  never a mix. :meth:`ModelRegistry.swap_params` builds a NEW module from the
  checkpoint's numpy state dict (a copy of the served one, loaded and left on
  its device, the copies finished) and only then swaps the reference under
  the lock: it never loads weights in place into the module being served, so
  a batch the batcher thread is enqueueing cannot read half a swap.
- :class:`CheckpointWatcher` polls a checkpoint directory (the trainer's
  ``saved_models/``) and swaps in the newest complete checkpoint that was not
  saved degraded, after :func:`ddr_tpu_torch.training.load_state`'s manifest
  and architecture checks. A corrupt or arch-mismatched file is logged once
  and skipped; the service keeps answering with the weights it has. Unlike
  the JAX watcher, which remembers only the last file it tried, this one
  remembers the file it loaded apart from the files that failed, so the scan
  that lands on the loaded checkpoint again after a corrupt one was
  quarantined does not swap the same weights in as a new version.

The ``registry.reload`` fault site (:mod:`~ddr_tpu_torch.observability.faults`)
fires before each hot-reload load, as in the JAX watcher. Its training-mesh
note (ROADMAP A.13) has no counterpart yet.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["CheckpointWatcher", "ModelEntry", "ModelRegistry", "module_with_params"]


def module_with_params(template: torch.nn.Module, params: Any) -> torch.nn.Module:
    """A new module like ``template`` (same class, shapes and device) holding
    ``params`` (a state dict of numpy arrays or tensors), in eval mode, its
    copies to the device finished. ``template`` is only read. A state dict of
    another architecture raises (``load_state_dict`` is strict)."""
    with torch.no_grad():  # grad mode is per thread: the watcher thread sets its own
        module = copy.deepcopy(template)
        module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
    module.eval()
    device = next(module.parameters()).device
    if device.type == "cuda":
        # the swap must not become visible before the new weights are on the card
        torch.cuda.synchronize(device)
    return module


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One registered model at one version: an immutable snapshot (swaps
    replace the whole entry)."""

    name: str
    kan: torch.nn.Module  # the served module of this version; never modified
    version: int
    arch: dict | None = None  # architecture fingerprint checked on reload
    source: str | None = None  # checkpoint path, or None for in-memory weights


class ModelRegistry:
    """Thread-safe name -> :class:`ModelEntry` map with an atomic swap."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, ModelEntry] = {}
        self._watchers: list[CheckpointWatcher] = []

    def register(self, name: str, kan: torch.nn.Module, arch: dict | None = None,
                 source: str | None = None) -> ModelEntry:
        entry = ModelEntry(name=name, kan=kan.eval(), version=1, arch=arch, source=source)
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} is already registered")
            self._entries[name] = entry
        return entry

    def get(self, name: str) -> ModelEntry:
        """One atomic snapshot: a caller holds it for the whole batch."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"unknown model {name!r}")
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def unregister(self, name: str) -> ModelEntry:
        """Remove ``name`` and stop its checkpoint watchers; batches holding
        a snapshot finish on it."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"unknown model {name!r}")
            del self._entries[name]
            watchers = [w for w in self._watchers if w._model == name]
            self._watchers = [w for w in self._watchers if w._model != name]
        for w in watchers:
            w.stop()
        log.info(f"model {name!r} unregistered (was version {entry.version})")
        return entry

    def swap_params(self, name: str, params: Any, source: str | None = None) -> ModelEntry:
        """Replace ``name``'s weights with ``params`` (a state dict) and
        return the new entry. The new module is built and placed first,
        outside the lock; the swap itself only rebinds the reference. Arch
        and name carry over: another architecture is another model."""
        module = module_with_params(self.get(name).kan, params)
        with self._lock:
            old = self._entries.get(name)
            if old is None:
                raise KeyError(f"unknown model {name!r}")
            entry = dataclasses.replace(old, kan=module, version=old.version + 1, source=source)
            self._entries[name] = entry
        log.info(f"model {name!r} hot-reloaded to version {entry.version}"
                 + (f" from {source}" if source else ""))
        return entry

    # ---- checkpoint watching ----

    def watch(self, name: str, directory: str | Path, poll_s: float = 2.0,
              on_reload: Callable[[ModelEntry], None] | None = None) -> "CheckpointWatcher":
        """Start a daemon watcher that hot-reloads ``name`` from the newest
        complete checkpoint under ``directory``; the entry's ``arch`` guards
        every load."""
        entry = self.get(name)  # raises early on unknown names
        watcher = CheckpointWatcher(registry=self, name=name, directory=Path(directory),
                                    expected_arch=entry.arch, poll_s=poll_s, on_reload=on_reload)
        watcher.start()
        with self._lock:
            self._watchers.append(watcher)
        return watcher

    def close(self) -> None:
        with self._lock:
            watchers, self._watchers = self._watchers, []
        for w in watchers:
            w.stop()


class CheckpointWatcher(threading.Thread):
    """Poll a checkpoint directory; swap the newest complete checkpoint in.

    Polling keeps this standard library only and safe on network and overlay
    filesystems. :meth:`check_now` runs one synchronous scan."""

    def __init__(
        self,
        registry: ModelRegistry,
        name: str,
        directory: Path,
        expected_arch: dict | None,
        poll_s: float = 2.0,
        on_reload: Callable[[ModelEntry], None] | None = None,
    ) -> None:
        super().__init__(name=f"ddr-torch-watch-{name}", daemon=True)
        self._registry = registry
        self._model = name
        self._dir = directory
        self._arch = expected_arch
        self._poll_s = max(0.05, float(poll_s))
        self._on_reload = on_reload
        self._stop_requested = threading.Event()
        self._loaded: tuple[str, float] | None = None  # (path, mtime) swapped in last
        self._failed: set[tuple[str, float]] = set()  # unloadable files, warned about once
        self._degraded_seen: set[str] = set()  # degraded files warned about once

    def run(self) -> None:
        while not self._stop_requested.wait(self._poll_s):
            try:
                self.check_now()
            except Exception:  # a dead watcher would serve stale weights forever
                log.exception(f"checkpoint watch on {self._dir} failed; retrying")

    def stop(self, join: bool = True) -> None:
        self._stop_requested.set()
        if join and self.is_alive():
            self.join(timeout=5.0)

    def check_now(self) -> bool:
        """One scan and reload attempt; True when a swap happened.

        The candidate walk skips ``.tmp`` leftovers and ``.corrupt``
        quarantines; ``load_state`` verifies the manifest and quarantines a
        torn or bit-flipped blob, so the next scan lands on the previous
        good checkpoint. Checkpoints whose manifest records ``degraded``
        (saved while the training watchdog was violating) are never loaded:
        the scan walks back to the newest one saved healthy. Each bad file
        warns once."""
        from ddr_tpu_torch.observability.faults import maybe_inject
        from ddr_tpu_torch.training import checkpoint_candidates, checkpoint_degraded, load_state

        path = None
        try:
            for cand in checkpoint_candidates(self._dir):
                if checkpoint_degraded(cand) is not True:
                    path = cand
                    break
                if str(cand) not in self._degraded_seen:
                    self._degraded_seen.add(str(cand))
                    log.warning(f"checkpoint {cand.name} was saved while training was degraded; "
                                "not hot-loading it")
        except OSError as e:
            log.warning(f"checkpoint watch on {self._dir}: {e}")
            return False
        if path is None:
            return False
        try:
            mtime = path.stat().st_mtime
        except OSError:
            return False  # racing a writer's rename; the next poll sees it
        stamp = (str(path), mtime)
        if stamp == self._loaded or stamp in self._failed:
            return False
        try:
            t0 = time.perf_counter()
            maybe_inject("registry.reload", path=str(path), model=self._model)
            blob = load_state(path, expected_arch=self._arch)
            entry = self._registry.swap_params(self._model, blob["params"], source=str(path))
            log.info(f"hot-reload of {self._model!r} from {path.name} took "
                     f"{time.perf_counter() - t0:.3f}s")
        except Exception as e:  # noqa: BLE001 - any unloadable checkpoint keeps the old weights
            log.warning(f"checkpoint {path} not loadable ({e}); keeping current params")
            self._failed.add(stamp)
            return False
        self._loaded = stamp
        if self._on_reload is not None:
            self._on_reload(entry)
        return True
