"""Forecast client over HTTP.

The port's copy of ``ddr_tpu/serving/client.py``'s HTTP half:
:class:`HttpForecastClient` talks to a running ``serve`` command over
``urllib`` (standard library and numpy only), sends each forecast once, and
asks for ensembles with an ``ensemble`` body; it writes a ``q_prime`` payload
in 9 significant digits a value (:func:`q_prime_json`), which carries every
float32 exactly in half the bytes of JAX's client. JAX's in-process
``ForecastClient`` and its retry loop (``retries``, ``Retry-After``) are not
ported: the fleet router, the one caller the port has for a failing replica,
is the retry layer itself and sends each request once
(:class:`~ddr_tpu_torch.fleet.router.HttpReplica`).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any

import numpy as np

__all__ = ["HttpForecastClient", "q_prime_json"]


def q_prime_json(q_prime: Any) -> str:
    """A ``(T, N)`` inflow as a JSON array of its float32 values, each in 9
    significant digits: within 5e-9 of the value relatively, far inside its
    float32 rounding interval (at least 2**-25 wide on either side), so the
    server's float64 parse rounds back to the same float32 exactly. About
    half the bytes of the float64 ``repr`` that ``json.dumps`` writes: a
    72 h x 65,536-reach window stays under the server's body limit. A
    non-finite value takes ``json.dumps``'s own spelling, and a zero
    ``repr``'s (``-0`` would parse as the integer 0 and lose its sign)."""
    q = np.asarray(q_prime, dtype=np.float32)
    if q.ndim != 2 or not np.isfinite(q).all():
        return json.dumps(q.tolist())
    nine = "{:.9g}".format

    def fmt(v: float) -> str:
        return nine(v) if v else repr(v)

    return "[" + ",".join("[" + ",".join(map(fmt, row.tolist())) + "]" for row in q) + "]"


class HttpForecastClient:
    """Standard-library client for the JSON API."""

    def __init__(self, base_url: str, timeout: float = 60.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> tuple[int, dict]:
        try:
            with urllib.request.urlopen(self.base_url + path, timeout=self.timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def healthy(self) -> bool:
        """False, not an exception, when the server is down or unreachable."""
        try:
            code, _ = self._get("/healthz")
        except urllib.error.URLError:
            return False
        return code == 200

    def ready(self) -> bool:
        try:
            code, _ = self._get("/readyz")
        except urllib.error.URLError:
            return False
        return code == 200

    def stats(self) -> dict:
        code, body = self._get("/v1/stats")
        if code != 200:
            raise RuntimeError(f"/v1/stats -> {code}: {body}")
        return body

    def forecast_response(
        self,
        network: str,
        model: str = "default",
        q_prime: Any | None = None,
        t0: int | None = None,
        gauges: list[int] | None = None,
        deadline_ms: float | None = None,
        request_id: str | None = None,
        priority: str | None = None,
        ensemble: dict | None = None,
    ) -> tuple[int, dict]:
        """POST /v1/forecast; returns ``(status, body)`` without raising on an
        HTTP error (a 429 or 503 is a data point for a load generator).
        ``ensemble`` (e.g. ``{"members": 16, "percentiles": [10, 50, 90],
        "seed": 0}``) asks for an E-member ensemble, whose ``runoff`` is
        ``(P, T, G)``."""
        body: dict[str, Any] = {"network": network, "model": model}
        if t0 is not None:
            body["t0"] = int(t0)
        if gauges is not None:
            body["gauges"] = [int(g) for g in gauges]
        if deadline_ms is not None:
            body["deadline_ms"] = float(deadline_ms)
        if priority is not None:
            body["priority"] = str(priority)
        if ensemble is not None:
            body["ensemble"] = dict(ensemble)
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers["X-DDR-Request-Id"] = str(request_id)
        text = json.dumps(body)
        if q_prime is not None:  # spliced in: the inflow is most of the body
            text = text[:-1] + ', "q_prime": ' + q_prime_json(q_prime) + "}"
        req = urllib.request.Request(self.base_url + "/v1/forecast", data=text.encode("utf-8"),
                                     headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except json.JSONDecodeError:
                return e.code, {}

    def forecast(
        self,
        network: str,
        model: str = "default",
        q_prime: Any | None = None,
        t0: int | None = None,
        gauges: list[int] | None = None,
        deadline_ms: float | None = None,
        request_id: str | None = None,
        priority: str | None = None,
        ensemble: dict | None = None,
    ) -> dict:
        """POST /v1/forecast; raises RuntimeError with the server's error on
        any non-200. ``runoff`` comes back as a float32 array: ``(T, G)``, or
        the ``(P, T, G)`` bands of an ensemble, whose ``mean`` is one too."""
        code, out = self.forecast_response(
            network, model=model, q_prime=q_prime, t0=t0, gauges=gauges, deadline_ms=deadline_ms,
            request_id=request_id, priority=priority, ensemble=ensemble,
        )
        if code != 200:
            raise RuntimeError(f"forecast failed ({code}): {out.get('error', out)}")
        out["runoff"] = np.asarray(out["runoff"], dtype=np.float32)
        if "mean" in out:
            out["mean"] = np.asarray(out["mean"], dtype=np.float32)
        return out
