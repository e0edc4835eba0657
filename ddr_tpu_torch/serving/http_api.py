"""Standard-library HTTP JSON front for :class:`~ddr_tpu_torch.serving.service.ForecastService`.

The port of ``ddr_tpu/serving/http_api.py``, on ``http.server.ThreadingHTTPServer``:
each connection gets a thread, and every thread funnels into the service's
micro-batcher, which is where concurrent requests coalesce. The API is the
JAX package's:

- ``GET /healthz`` — liveness (200 whenever the server answers);
- ``GET /readyz`` — 200 after :meth:`ForecastService.warmup`; 503
  ``warming`` before it, 503 ``warmup-failed`` when it raised (terminal), 503
  ``unhealthy`` while the numerical-health watchdog reports degraded;
- ``GET /metrics`` — the service's metrics registry in Prometheus text;
  ``GET /metrics?federated=1`` scrapes the replicas this one knows
  (``DDR_FEDERATE_REPLICAS``) and folds its own registry in as
  ``replica="self"`` (:func:`~ddr_tpu_torch.observability.federate.federate_text`);
- ``GET /v1/models``, ``/v1/networks``, ``/v1/stats``;
- ``POST /v1/forecast`` — body ``{"network": str, "model"?: str,
  "q_prime"?: [[...]], "t0"?: int, "gauges"?: [int], "deadline_ms"?: num,
  "priority"?: "interactive"|"batch"|"bulk"}``; answers ``{"runoff":
  [[...]], "version", "engine", "request_id", "queue_s", "execute_s", ...}``.
  A caller's ``X-DDR-Request-Id`` is sanitised and adopted (else one is
  minted), and every answer on this path, errors included, echoes it in the
  header and the body; ``X-DDR-Trace-Id`` rides the same way unless
  ``DDR_TRACE=0``. Shed and reject bodies carry a machine-readable
  ``reason`` (``queue-full``, ``deadline``, ``timeout``, ...). A body with
  ``"ensemble": {"members"?: int, "percentiles"?: [num], "seed"?: int}``
  asks for an E-member ensemble, answered on the connection's thread (it
  does not ride the micro-batcher) with the ``(P, T, G)`` bands as
  ``runoff``, ``mean`` and ``worst``;
- ``POST /v1/observe`` — body ``{"network": str, "observations": [{"gauge":
  str|int, "times": [int hours], "values": [num]}, ...]}``: joins gauge
  observations to the forecasts the attached verification ledger holds and
  answers the join's counts (``matched``, ``unmatched``, ``duplicates``);
  404 when no ledger is attached (``ForecastService.attach_verifier``);
- ``POST /v1/profile?seconds=N`` — a ``torch.profiler`` capture of live
  traffic for N seconds (default 2, at most ``DDR_SERVE_PROFILE_MAX_SECONDS``):
  202 ``{"status": "capturing", "seconds", "trace_dir"}`` at once, the Chrome
  trace written under ``DDR_METRICS_DIR`` (else the active run log's
  directory, else a fresh temporary directory) when the window ends; 400 for
  a bad or over-cap N, 409 while a capture or a ``trace()`` runs, 500 when
  the profiler fails to start
  (:func:`~ddr_tpu_torch.observability.spans.capture_profile`).

Error mapping: validation -> 400, unknown name -> 404, queue-full rejection ->
429 (with ``Retry-After``), shed or deadline -> 503, not warm -> 503.
"""

from __future__ import annotations

import json
import logging
import tempfile
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ddr_tpu_torch.observability.events import get_recorder, metrics_dir_from_env
from ddr_tpu_torch.observability.federate import federate_text, replicas_from_env
from ddr_tpu_torch.observability.prometheus import CONTENT_TYPE, render_text
from ddr_tpu_torch.observability.spans import ProfilerBusyError, capture_profile
from ddr_tpu_torch.observability.trace import adopt_trace_id, trace_enabled
from ddr_tpu_torch.serving.batcher import QueueFullError, RequestShedError
from ddr_tpu_torch.serving.service import ForecastService, make_request_id

log = logging.getLogger(__name__)

__all__ = ["MAX_BODY_BYTES", "ForecastHTTPServer", "serve_http"]

#: Hard ceiling on a request body (a full-width 72 h x 65,536-reach q_prime
#: is ~47 MB of JSON; bulk forcings belong in a registered network).
MAX_BODY_BYTES = 64 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    server: "ForecastHTTPServer"

    # ---- plumbing ----

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        log.debug("http %s", format % args)

    def _send_bytes(self, code: int, data: bytes, content_type: str, headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):  # the client went away
            pass

    def _send(self, code: int, payload: dict, headers: dict | None = None) -> None:
        self._send_bytes(code, json.dumps(payload).encode("utf-8"), "application/json", headers)

    def _read_json(self, send) -> Any:
        """The request body as JSON, or None after answering 400."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            send(400, {"error": "bad Content-Length"})
            return None
        if length <= 0 or length > MAX_BODY_BYTES:
            send(400, {"error": f"body must be 1..{MAX_BODY_BYTES} bytes"})
            return None
        try:
            return json.loads(self.rfile.read(length))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            send(400, {"error": f"invalid JSON body: {e}"})
            return None

    # ---- GET ----

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        svc = self.server.service
        url = urlsplit(self.path)
        if url.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif url.path == "/readyz":
            self._send(*self._readyz(svc))
        elif url.path == "/metrics":
            if parse_qs(url.query).get("federated", ["0"])[0] not in ("", "0", "false"):
                # the fleet view: any replica answers for the group it knows
                text = federate_text(replicas_from_env(), local=("self", svc.metrics))
            else:
                text = render_text(svc.metrics)
            self._send_bytes(200, text.encode("utf-8"), CONTENT_TYPE)
        elif url.path == "/v1/stats":
            self._send(200, svc.stats())
        elif url.path == "/v1/models":
            self._send(200, {"models": svc.models_info()})
        elif url.path == "/v1/networks":
            self._send(200, {"networks": svc.networks_info()})
        else:
            self._send(404, {"error": f"no route for {self.path}"})

    @staticmethod
    def _readyz(svc: ForecastService) -> tuple[int, dict]:
        """warmup-failed and degraded are both 503 with distinct statuses: a
        failed warmup is terminal, a degraded watchdog clears itself on the
        next healthy batch."""
        if svc.warmup_error is not None:
            return 503, {"status": "warmup-failed", "error": svc.warmup_error}
        if not svc.ready:
            return 503, {"status": "warming"}
        if svc.watchdog.degraded:
            return 503, {"status": "unhealthy", "consecutive_bad": svc.watchdog.consecutive_bad}
        return 200, {"status": "ready"}

    # ---- POST ----

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        path = urlsplit(self.path).path
        if path == "/v1/profile":
            self._post_profile()
            return
        if path == "/v1/observe":
            self._post_observe()
            return
        if path != "/v1/forecast":
            self._send(404, {"error": f"no route for {self.path}"})
            return
        svc = self.server.service
        # ids exist from the first byte, and every answer on this path echoes them
        rid = make_request_id(self.headers.get("X-DDR-Request-Id"))
        tid = adopt_trace_id(self.headers.get("X-DDR-Trace-Id")) if trace_enabled() else None

        def send(code: int, payload: dict, headers: dict | None = None) -> None:
            payload.setdefault("request_id", rid)
            hdrs = {"X-DDR-Request-Id": rid, **(headers or {})}
            if tid is not None:
                payload.setdefault("trace_id", tid)
                hdrs.setdefault("X-DDR-Trace-Id", tid)
            self._send(code, payload, headers=hdrs)

        if not svc.ready:
            send(503, {"error": "service is warming up", "status": "warming"})
            return
        body = self._read_json(send)
        if body is None:
            return
        if not isinstance(body, dict) or "network" not in body:
            send(400, {"error": 'body must be an object with "network"'})
            return
        if body.get("ensemble") is not None:
            self._post_ensemble(svc, body, body["ensemble"], rid, tid, send)
            return
        deadline_ms = body.get("deadline_ms")
        try:
            fut = svc.submit(
                network=str(body["network"]),
                model=str(body.get("model", "default")),
                q_prime=body.get("q_prime"),
                t0=body.get("t0"),
                gauges=body.get("gauges"),
                deadline_s=None if deadline_ms is None else float(deadline_ms) / 1e3,
                request_id=rid,
                trace_id=tid,
                priority=body.get("priority"),
            )
        except QueueFullError as e:
            send(429, {"error": str(e), "reason": "queue-full"}, headers={"Retry-After": "1"})
            return
        except KeyError as e:
            send(404, {"error": f"unknown model {e}"})
            return
        except ValueError as e:
            send(404 if "unknown network" in str(e) else 400, {"error": str(e)})
            return
        except TypeError as e:  # np.asarray of e.g. a dict q_prime: still malformed
            send(400, {"error": f"malformed request value: {e}"})
            return
        try:
            # wait a little past the deadline: the batcher's own shed is the
            # informative error
            wait = (float(deadline_ms) / 1e3 if deadline_ms is not None
                    else svc.serve_cfg.deadline_s) + 5.0
            result = fut.result(timeout=wait)
        except RequestShedError as e:
            send(503, {"error": str(e), "reason": e.reason})
            return
        except FutureTimeoutError:
            send(503, {"error": "request timed out in service", "reason": "timeout"})
            return
        except Exception as e:  # an executor failure surfaced on the future
            send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        result = dict(result)
        result["runoff"] = np.asarray(result["runoff"]).tolist()
        send(200, result)

    @staticmethod
    def _post_ensemble(svc: ForecastService, body: dict, ensemble: Any, rid: str,
                       tid: str | None, send: Any) -> None:
        """The ``"ensemble"`` branch of POST /v1/forecast, with the scalar
        path's error mapping. It routes on this connection's thread."""
        if not isinstance(ensemble, dict):
            send(400, {"error": '"ensemble" must be an object'})
            return
        try:
            result = svc.ensemble_forecast(
                network=str(body["network"]),
                model=str(body.get("model", "default")),
                q_prime=body.get("q_prime"),
                t0=body.get("t0"),
                gauges=body.get("gauges"),
                members=int(ensemble.get("members", 8)),
                percentiles=ensemble.get("percentiles"),
                seed=int(ensemble.get("seed", 0)),
                request_id=rid,
                trace_id=tid,
            )
        except KeyError as e:
            send(404, {"error": f"unknown model {e}"})
            return
        except ValueError as e:
            send(404 if "unknown network" in str(e) else 400, {"error": str(e)})
            return
        except TypeError as e:
            send(400, {"error": f"malformed request value: {e}"})
            return
        except Exception as e:
            send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        result = dict(result)
        result["runoff"] = np.asarray(result["runoff"]).tolist()  # (P, T, G)
        result["mean"] = np.asarray(result["mean"]).tolist()
        result.pop("member_runoff", None)
        send(200, result)

    def _post_observe(self) -> None:
        """``POST /v1/observe``: gauge observations into the attached
        ledger's delayed join; answers its counts. 404 without a ledger."""
        verifier = self.server.service.verifier
        if verifier is None:
            self._send(404, {"error": "no verification ledger attached (service.attach_verifier)"})
            return
        body = self._read_json(self._send)
        if body is None:
            return
        if not isinstance(body, dict) or "network" not in body or not isinstance(
                body.get("observations"), list):
            self._send(400, {"error": 'body must be an object with "network" and an "observations" list'})
            return
        try:
            stats = verifier.observe(str(body["network"]), body["observations"], source="http")
        except (KeyError, TypeError, ValueError) as e:
            self._send(400, {"error": f"malformed observations: {e}"})
            return
        except Exception as e:
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, stats)


    def _post_profile(self) -> None:
        """``POST /v1/profile?seconds=N``: answer 202 at once and capture N
        seconds of live traffic while the service keeps serving (see the
        module docstring)."""
        svc = self.server.service
        raw = parse_qs(urlsplit(self.path).query).get("seconds", ["2"])[0]
        try:
            seconds = float(raw)
        except ValueError:
            self._send(400, {"error": f"seconds={raw!r} is not a number"})
            return
        cap = svc.serve_cfg.profile_max_seconds
        if not 0 < seconds <= cap:
            self._send(400, {"error": f"seconds must be in (0, {cap}] "
                                      f"(DDR_SERVE_PROFILE_MAX_SECONDS), got {seconds}"})
            return
        rec = get_recorder()
        trace_dir = metrics_dir_from_env() or (
            str(rec.path.parent) if rec is not None else tempfile.mkdtemp(prefix="ddr-profile-"))
        try:
            capture_profile(trace_dir, seconds)
        except ProfilerBusyError as e:
            self._send(409, {"error": str(e)})
            return
        except Exception as e:  # the profiler failed to start: a server-side fault
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(202, {"status": "capturing", "seconds": seconds, "trace_dir": trace_dir})


class ForecastHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP server bound to one :class:`ForecastService`. Its
    accept queue holds 128 pending connections, where ``socketserver``'s
    default holds 5: an open loop of 80 requests a second with up to 64 in
    flight overflowed that, and a client now and then had its connection
    reset."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, service: ForecastService, host: str, port: int) -> None:
        self.service = service
        super().__init__((host, port), _Handler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def serve_http(
    service: ForecastService, host: str | None = None, port: int | None = None, block: bool = False,
) -> ForecastHTTPServer:
    """Start the HTTP front (ServeConfig host and port by default; ``port=0``
    binds an ephemeral port, read it from ``server.url``). ``block=True``
    serves on this thread until interrupted (the ``serve`` command);
    otherwise a daemon thread serves and the server is returned, to be
    stopped with ``shutdown()`` and ``server_close()``."""
    host = service.serve_cfg.host if host is None else host
    port = service.serve_cfg.port if port is None else port
    server = ForecastHTTPServer(service, host, port)
    log.info(f"forecast API listening on {server.url}")
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
        return server
    threading.Thread(target=server.serve_forever, name="ddr-torch-http", daemon=True).start()
    return server
