"""ReplicaGroup: N data-parallel forecast replicas behind one router.

The port of ``ddr_tpu/fleet/group.py``. Two member shapes, one group surface:

- ``inprocess``: N :class:`~ddr_tpu_torch.serving.service.ForecastService`
  instances built in this process by a caller's ``builder(index)``;
  ``http=True`` fronts each with its own HTTP server, so the group can be
  scraped and federated;
- ``subprocess``: N ``python -m ddr_tpu_torch.cli serve`` workers on distinct
  ports, each killable on its own. Each worker gets its fleet identity
  (``DDR_FLEET_GROUP`` / ``DDR_FLEET_REPLICA`` / ``DDR_FLEET_ROUTER``) in its
  environment, so its boot log and ``/v1/stats`` name its slot in the group.

One departure from the JAX group: JAX stamps ``DDR_COMPILE_CACHE_DIR`` into
every worker so that replicas 2..N warm from replica 1's XLA compiles. The
port has no compile cache to share. Every worker loads the CUDA kernels from
``build/kernels`` at the root of the checkout, and
:func:`~ddr_tpu_torch.routing._build.build` writes each library to a
per-process temporary file and moves it into place with ``os.replace``, so
two cold workers cannot tear a library. Nothing is stamped in its place.

At boot the group sets ``DDR_FEDERATE_REPLICAS`` to every addressable
member, so ``GET /metrics?federated=1`` on any replica sees the whole group;
the previous value is restored on :meth:`ReplicaGroup.close`.

Dispatch goes through :class:`~ddr_tpu_torch.fleet.router.Router` (least
queue depth, health-aware ejection); :meth:`ReplicaGroup.kill_replica` and
:meth:`ReplicaGroup.restart_replica` are the surface a failure drill uses.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable

from ddr_tpu_torch.fleet.config import FleetConfig
from ddr_tpu_torch.fleet.router import HttpReplica, InProcessReplica, Router

log = logging.getLogger(__name__)

__all__ = ["ReplicaGroup"]


def _free_port() -> int:
    """An ephemeral port from the kernel. Racy: the probe socket closes
    before the worker binds, so on a busy host another process can take the
    port in between; boot relaunches the group on fresh ports when that
    happens (a bounded number of times)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ReplicaExitedDuringBoot(RuntimeError):
    """A subprocess replica died before it was ready: on ephemeral ports the
    likely cause is the port race, so boot retries."""


class ReplicaGroup:
    """N forecast replicas, one front door. See the module docstring."""

    def __init__(
        self,
        fleet_cfg: FleetConfig | None = None,
        builder: Callable[[int], Any] | None = None,
        serve_args: list[str] | None = None,
        workdir: str | Path | None = None,
        http: bool = False,
        boot_timeout: float = 300.0,
        client_timeout: float = 30.0,
        extra_env: dict[str, str] | None = None,
    ) -> None:
        """``builder(index) -> ForecastService`` drives ``inprocess`` mode
        (required there; each call returns a warmed or warmable service);
        ``serve_args`` is the ``serve`` argv tail (the config path and its
        ``a.b=c`` overrides) of ``subprocess`` mode. ``extra_env`` goes into
        every subprocess worker's environment (``DDR_SERVE_MAX_BATCH`` and
        the like)."""
        self.cfg = fleet_cfg or FleetConfig.from_env()
        self._builder = builder
        self._serve_args = list(serve_args or [])
        self._extra_env = dict(extra_env or {})
        self._http = bool(http)
        self._boot_timeout = float(boot_timeout)
        self._client_timeout = float(client_timeout)
        self._workdir = Path(workdir or tempfile.mkdtemp(prefix=f"ddr-fleet-{self.cfg.group}-"))
        self._workdir.mkdir(parents=True, exist_ok=True)  # the workers' boot logs go here
        self._lock = threading.Lock()
        self._procs: dict[int, subprocess.Popen | None] = {}
        self._ports: dict[int, int] = {}
        self._boot_counts: dict[int, int] = {}
        self._servers: list[Any] = []  # in-process HTTP fronts
        self._prev_federate: str | None = None
        self._published = False
        self.replicas: list[Any] = []
        self.router: Router | None = None
        if self.cfg.mode == "inprocess" and builder is None:
            raise ValueError("inprocess mode needs a builder(index) callable")
        if self.cfg.mode == "subprocess" and not self._serve_args:
            raise ValueError("subprocess mode needs serve_args (the `serve` argv tail)")

    # ---- boot ----

    def boot(self) -> "ReplicaGroup":
        """Build or launch every replica, wait until each is ready, publish
        the federation targets and start the router. Returns self."""
        t0 = time.perf_counter()
        if self.cfg.mode == "inprocess":
            self._boot_inprocess()
        else:
            self._boot_subprocess()
        self._publish_federation()
        self.router = Router(self.replicas, probe_s=self.cfg.probe_s, eject_after=self.cfg.eject_after)
        log.info(f"fleet group {self.cfg.group!r} up: {len(self.replicas)} {self.cfg.mode} "
                 f"replica(s) in {time.perf_counter() - t0:.1f}s")
        return self

    def _boot_inprocess(self) -> None:
        for i in range(self.cfg.replicas):
            service = self._builder(i)
            replica = InProcessReplica(service, i, name=self._name(i))
            if self._http:
                from ddr_tpu_torch.serving.http_api import serve_http

                server = serve_http(service, host="127.0.0.1", port=0)
                self._servers.append(server)
                replica.url = server.url
            self.replicas.append(replica)

    def _replica_env(self, index: int, port: int) -> dict[str, str]:
        env = dict(os.environ)
        env.pop("DDR_METRICS_DIR", None)  # workers log under their own save paths
        env.update(self._extra_env)
        env.update({
            "DDR_SERVE_HOST": "127.0.0.1",
            "DDR_SERVE_PORT": str(port),
            "DDR_FLEET_GROUP": self.cfg.group,
            "DDR_FLEET_REPLICA": str(index),
            "DDR_FLEET_ROUTER": f"local:{os.getpid()}",
        })
        # every worker carries the whole group's targets, so a federated
        # scrape of any survivor reports ddr_federate_up for all of them
        targets = self._federation_targets()
        if targets:
            env["DDR_FEDERATE_REPLICAS"] = ",".join(targets)
        return env

    def _federation_targets(self) -> list[str]:
        if self.cfg.mode == "subprocess":
            return [f"{self._name(i)}=http://127.0.0.1:{self._ports[i]}/metrics" for i in sorted(self._ports)]
        return [f"{r.name}={r.url}/metrics" for r in self.replicas if r.url]

    def _launch_one(self, index: int) -> HttpReplica:
        port = self._ports.setdefault(index, self.cfg.base_port + index if self.cfg.base_port else _free_port())
        attempt = self._boot_counts.get(index, 0) + 1
        self._boot_counts[index] = attempt
        log_path = self._workdir / f"replica_{index}_boot{attempt}.out"
        with log_path.open("ab") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ddr_tpu_torch.cli", "serve", *self._serve_args],
                stdout=fh, stderr=subprocess.STDOUT, env=self._replica_env(index, port),
            )
        with self._lock:
            self._procs[index] = proc
        return HttpReplica(f"http://127.0.0.1:{port}", index, name=self._name(index),
                           timeout=self._client_timeout)

    def _boot_subprocess(self) -> None:
        # a worker that dies during boot on ephemeral ports gets the whole
        # group relaunched on fresh ports: reallocating one port would strand
        # the target list already in the other workers' environments. With
        # base_port the operator owns the range, so a collision is an error.
        attempts = 1 if self.cfg.base_port else 3
        for attempt in range(1, attempts + 1):
            # every port first: the target list must be whole before the
            # first worker's environment is written
            for i in range(self.cfg.replicas):
                self._ports.setdefault(i, self.cfg.base_port + i if self.cfg.base_port else _free_port())
            self.replicas = [self._launch_one(i) for i in range(self.cfg.replicas)]
            try:
                self._await_ready()
                return
            except _ReplicaExitedDuringBoot as e:
                self._kill_all_procs()
                if attempt == attempts:
                    raise
                log.warning(f"{e}; relaunching the group on fresh ports (attempt {attempt + 1}/{attempts})")
                self._ports.clear()
                self.replicas = []
            except BaseException:
                self._kill_all_procs()  # no worker outlives a failed boot
                raise

    def _await_ready(self) -> None:
        deadline = time.monotonic() + self._boot_timeout
        for replica in self.replicas:
            while not replica.ready():
                proc = self._procs.get(replica.index)
                if proc is not None and proc.poll() is not None:
                    raise _ReplicaExitedDuringBoot(
                        f"replica {replica.name} exited rc={proc.returncode} during boot — see {self._workdir}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"replica {replica.name} not ready within {self._boot_timeout}s — see {self._workdir}")
                time.sleep(0.25)

    def _kill_all_procs(self) -> None:
        with self._lock:
            procs = [p for p in self._procs.values() if p is not None]
            self._procs.clear()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            proc.wait()

    def _name(self, index: int) -> str:
        return f"{self.cfg.group}-r{index}"

    def _publish_federation(self) -> None:
        """Set ``DDR_FEDERATE_REPLICAS`` to every addressable member
        (in-process replicas without an HTTP front have no scrape URL)."""
        targets = self._federation_targets()
        if not targets:
            return
        self._prev_federate = os.environ.get("DDR_FEDERATE_REPLICAS")
        self._published = True
        os.environ["DDR_FEDERATE_REPLICAS"] = ",".join(targets)
        log.info(f"federation targets published: {len(targets)} replica(s)")

    # ---- dispatch (the front door) ----

    def forecast(self, **kwargs) -> dict:
        if self.router is None:
            raise RuntimeError("group not booted — call boot() first")
        return self.router.forecast(**kwargs)

    def ensemble(self, **kwargs) -> dict:
        if self.router is None:
            raise RuntimeError("group not booted — call boot() first")
        return self.router.ensemble(**kwargs)

    # ---- failure drills ----

    def kill_replica(self, index: int) -> None:
        """SIGKILL a subprocess replica (or down an in-process one). The
        router's probes and dispatch discover the death; nothing announces
        it."""
        replica = self.replicas[index]
        if self.cfg.mode == "inprocess":
            replica.kill()
        else:
            with self._lock:
                proc = self._procs.get(index)
            if proc is not None:
                proc.kill()
                proc.wait()
        log.info(f"replica {replica.name} killed")

    def restart_replica(self, index: int) -> None:
        """Bring a killed replica back on its port and slot; the router's
        prober readmits it on its first good probe."""
        if self.cfg.mode == "inprocess":
            self.replicas[index].revive()
            return
        replica = self._launch_one(index)
        # same name and port: swap the client into the router's slot (the
        # router keys its state by name)
        self.replicas[index].client = replica.client
        log.info(f"replica {self.replicas[index].name} restarting")

    # ---- inspection and lifecycle ----

    def describe(self) -> dict:
        return {
            "group": self.cfg.group,
            "mode": self.cfg.mode,
            "replicas": len(self.replicas),
            "workdir": str(self._workdir),
            "federation": os.environ.get("DDR_FEDERATE_REPLICAS"),
            "router": None if self.router is None else self.router.status(),
        }

    def pids(self) -> dict[int, int]:
        """Each live subprocess worker's pid, by replica index."""
        with self._lock:
            return {i: p.pid for i, p in self._procs.items() if p is not None and p.poll() is None}

    def close(self) -> None:
        if self.router is not None:
            self.router.close()
        for server in self._servers:
            try:
                server.shutdown()
                server.server_close()
            except Exception:
                log.exception("closing an HTTP front failed")
        if self.cfg.mode == "inprocess":
            for replica in self.replicas:
                try:
                    replica.service.close(drain=False)
                except Exception:
                    log.exception(f"closing {replica.name} failed")
        else:
            with self._lock:
                procs = [p for p in self._procs.values() if p is not None]
            for proc in procs:
                if proc.poll() is None:
                    proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=15.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        # restore the federation view the boot replaced
        if self._published:
            if self._prev_federate is None:
                os.environ.pop("DDR_FEDERATE_REPLICAS", None)
            else:
                os.environ["DDR_FEDERATE_REPLICAS"] = self._prev_federate
            self._published = False
