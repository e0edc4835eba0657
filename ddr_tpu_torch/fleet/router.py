"""The front door of a replica group: least-queue-depth dispatch with
health-aware ejection.

The port of ``ddr_tpu/fleet/router.py``. The router is dumb and bounded on
purpose: pick the healthy replica with the least outstanding work, send the
request, and treat transport failures as the health signal. A replica that
stops answering, or whose ``/readyz`` degrades, leaves rotation after
``eject_after`` consecutive failures; traffic goes to the survivors, the
prober keeps probing the dead one, and its first good probe readmits it.
One dead replica costs its in-flight requests, not the group.

Replicas are duck-typed: :class:`InProcessReplica` wraps a live
:class:`~ddr_tpu_torch.serving.service.ForecastService`, :class:`HttpReplica`
a ``serve`` worker's URL, so the group, the load generator and the tests
share one dispatch path.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

log = logging.getLogger(__name__)

__all__ = ["InProcessReplica", "HttpReplica", "Router", "NoHealthyReplicaError"]


class NoHealthyReplicaError(RuntimeError):
    """Every replica of the group is ejected or failing: the router's only
    unroutable state."""


class InProcessReplica:
    """One in-process :class:`ForecastService` member of a group.

    :meth:`kill` / :meth:`revive` stand in for a replica's death without a
    process boundary: probes and dispatch see ``ConnectionError``, what a
    SIGKILLed subprocess replica gives."""

    def __init__(self, service: Any, index: int, name: str | None = None) -> None:
        self.service = service
        self.index = int(index)
        self.name = name or f"r{index}"
        self.url: str | None = None  # set when the group fronts it with HTTP
        self._killed = False

    def kill(self) -> None:
        self._killed = True

    def revive(self) -> None:
        self._killed = False

    def _check_up(self) -> None:
        if self._killed:
            raise ConnectionError(f"replica {self.name} is down")

    def ready(self) -> bool:
        svc = self.service
        return not self._killed and bool(svc.ready) and not svc.watchdog.degraded

    def depth(self) -> int:
        self._check_up()
        return int(self.service._batcher.stats()["depth"])

    def forecast(self, **kwargs) -> dict:
        self._check_up()
        return self.service.forecast(**kwargs)

    def ensemble(self, **kwargs) -> dict:
        self._check_up()
        return self.service.ensemble_forecast(**kwargs)

    def stats(self) -> dict:
        return self.service.stats()


class HttpReplica:
    """One subprocess ``serve`` worker, addressed by URL."""

    def __init__(self, url: str, index: int, name: str | None = None,
                 timeout: float = 30.0) -> None:
        from ddr_tpu_torch.serving.client import HttpForecastClient

        self.url = url.rstrip("/")
        self.index = int(index)
        self.name = name or f"r{index}"
        # the client sends each request once: the router is the retry layer,
        # and a failing replica must fail fast so that it is ejected and the
        # request rerouted
        self.client = HttpForecastClient(self.url, timeout=timeout)

    def ready(self) -> bool:
        return self.client.ready()

    def depth(self) -> int:
        stats = self.client.stats()
        return int((stats.get("queue") or {}).get("depth") or 0)

    def forecast(self, **kwargs) -> dict:
        return self.client.forecast(**kwargs)

    def ensemble(self, members: int = 8, percentiles: Any | None = None, seed: int = 0,
                 **kwargs) -> dict:
        # the wire shape is the forecast body plus an "ensemble" object: the
        # client's forecast has no members/percentiles/seed parameters, so
        # they are folded into that object (dropping them would run a single
        # forecast)
        return self.client.forecast(
            **kwargs,
            ensemble={
                "members": int(members),
                "percentiles": None if percentiles is None else [float(p) for p in percentiles],
                "seed": int(seed),
            },
        )

    def stats(self) -> dict:
        return self.client.stats()


class Router:
    """Least-queue-depth dispatch over a replica list, with ejection.

    Depth = the replica's last probed queue depth + this router's in-flight
    count toward it (the probe cadence is too slow to see a burst; the local
    count is exact for the traffic this router sent, which behind one front
    door is all of it).
    """

    def __init__(self, replicas: list[Any], probe_s: float = 1.0, eject_after: int = 2) -> None:
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas = list(replicas)
        self.probe_s = float(probe_s)
        self.eject_after = int(eject_after)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # per-replica state, all guarded by _lock
        self._fails = {r.name: 0 for r in self.replicas}
        self._ejected = {r.name: False for r in self.replicas}
        self._inflight = {r.name: 0 for r in self.replicas}
        self._probed_depth = {r.name: 0 for r in self.replicas}
        self._dispatched = {r.name: 0 for r in self.replicas}
        self._errors = 0
        # the performance sentinel over the probed queue depths: one detector
        # a replica ("<name>.queue_depth"), fed at probe cadence, so a replica
        # falling behind its peers fires a fleet-scoped anomaly
        self._sentinel = None
        try:
            from ddr_tpu_torch.observability.sentinel import Sentinel, SentinelConfig

            cfg = SentinelConfig.from_env()
            if cfg.enabled:
                self._sentinel = Sentinel(cfg, scope="fleet")
        except Exception:
            log.exception("fleet sentinel disabled (bad DDR_SENTINEL_* config)")
        self._probes = 0
        self._prober = threading.Thread(target=self._probe_loop, name="ddr-fleet-prober", daemon=True)
        self._prober.start()

    # ---- dispatch ----

    def _pick(self, tried: set[str] = frozenset()) -> Any:
        with self._lock:
            live = [r for r in self.replicas if not self._ejected[r.name] and r.name not in tried]
            if not live:
                raise NoHealthyReplicaError(
                    f"no healthy replica in the group ({len(self.replicas)} ejected)")
            chosen = min(live, key=lambda r: (self._probed_depth[r.name] + self._inflight[r.name], r.index))
            self._inflight[chosen.name] += 1
            self._dispatched[chosen.name] += 1
            return chosen

    def _dispatch(self, method: str, kwargs: dict) -> dict:
        """Try each non-ejected replica at most once. A transport error counts
        a failure (ejecting at the threshold) and moves on: a dead replica
        costs the caller a retry, not an error. ``tried`` keeps one dispatch
        from picking again the replica that just failed it (a corpse not yet
        ejected stays the least-loaded pick and would eat every retry)."""
        last_exc: BaseException | None = None
        tried: set[str] = set()
        for _ in range(len(self.replicas)):
            try:
                replica = self._pick(tried)
            except NoHealthyReplicaError:
                break
            tried.add(replica.name)
            try:
                result = getattr(replica, method)(**kwargs)
            except (ConnectionError, OSError, TimeoutError) as e:
                # transport death is health signal: count it and reroute.
                # Application errors (validation, shed, an HTTP error the
                # client raises) propagate: they are the caller's answer
                last_exc = e
                self._mark_failure(replica)
                continue
            finally:
                with self._lock:
                    self._inflight[replica.name] = max(0, self._inflight[replica.name] - 1)
            self._mark_success(replica)
            return result
        with self._lock:
            self._errors += 1
        if last_exc is not None:
            raise NoHealthyReplicaError(
                f"every replica failed; last transport error: {last_exc!r}") from last_exc
        raise NoHealthyReplicaError("no healthy replica in the group")

    def forecast(self, **kwargs) -> dict:
        return self._dispatch("forecast", kwargs)

    def ensemble(self, **kwargs) -> dict:
        return self._dispatch("ensemble", kwargs)

    # ---- health ----

    def _mark_failure(self, replica: Any) -> None:
        with self._lock:
            self._fails[replica.name] += 1
            fails = self._fails[replica.name]
            ejected_now = fails >= self.eject_after and not self._ejected[replica.name]
            if ejected_now:
                self._ejected[replica.name] = True
        if ejected_now:
            log.warning(f"ejecting replica {replica.name} after {fails} consecutive failures; "
                        "re-probing in the background")

    def _mark_success(self, replica: Any) -> None:
        with self._lock:
            was_ejected = self._ejected[replica.name]
            self._fails[replica.name] = 0
            self._ejected[replica.name] = False
        if was_ejected:
            log.info(f"replica {replica.name} recovered; back in rotation")

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_s):
            for replica in self.replicas:
                if self._stop.is_set():
                    return
                try:
                    ok = replica.ready()
                    depth = replica.depth() if ok else 0
                except Exception:
                    ok, depth = False, 0
                if ok:
                    with self._lock:
                        self._probed_depth[replica.name] = depth
                    self._mark_success(replica)
                else:
                    self._mark_failure(replica)
                if self._sentinel is not None and ok:
                    try:
                        self._sentinel.observe(f"{replica.name}.queue_depth", float(depth),
                                               step=self._probes, direction="high")
                    except Exception:
                        log.exception("fleet sentinel observe failed")
            self._probes += 1

    # ---- inspection and lifecycle ----

    def healthy(self) -> list[str]:
        with self._lock:
            return [r.name for r in self.replicas if not self._ejected[r.name]]

    def status(self) -> dict:
        with self._lock:
            return {
                "replicas": [
                    {
                        "name": r.name,
                        "index": r.index,
                        "url": getattr(r, "url", None),
                        "ejected": self._ejected[r.name],
                        "consecutive_failures": self._fails[r.name],
                        "inflight": self._inflight[r.name],
                        "last_probed_depth": self._probed_depth[r.name],
                        "dispatched": self._dispatched[r.name],
                    }
                    for r in self.replicas
                ],
                "unroutable_errors": self._errors,
                "anomalies": None if self._sentinel is None else self._sentinel.status(),
            }

    def close(self) -> None:
        self._stop.set()
        self._prober.join(timeout=5.0)
