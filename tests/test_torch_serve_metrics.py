"""The port's serve metrics, ids and serving knobs against the JAX package's.

- ``MetricsRegistry`` + ``render_text``: the same seeded sequence of counter,
  gauge and histogram operations (labels that need escaping, NaN and
  infinite values, constant labels) renders to text byte for byte
  equal to JAX's; so do ``declare_serve_metrics``'s first scrape and the
  registry after the same ``event_tee`` records, less the compile family the
  port does not declare yet;
- ``make_request_id``, ``adopt_trace_id`` and ``trace_enabled`` equal JAX's
  on the same inputs and environments (minted ids: the same form);
- ``ServeConfig.from_env`` equals JAX's on the same environments, keyword
  overrides included, less the profiler's knob, and refuses what JAX refuses;
- the health watchdog's ``ddr_health_status`` and
  ``ddr_health_violations_total`` render equal to JAX's after every one of
  the same observations and flags;
- the service honours ``DDR_SERVE_*`` and sanitises a supplied request id.
"""

from __future__ import annotations

import importlib
import math
import re

import numpy as np
import pytest
import torch

from ddr_tpu.observability import health as jh
from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu.serving.config import ServeConfig as JaxServeConfig
from ddr_tpu.serving.service import make_request_id as jax_make_request_id
from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.observability import health as th
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability import trace as ttrace
from ddr_tpu_torch.observability.registry import MetricsRegistry, get_registry
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.service import ForecastService, make_request_id
from ddr_tpu_torch.validation.configs import Config, KanConfig

# the JAX package's observability namespace exports a ``trace`` function too
jtrace = importlib.import_module("ddr_tpu.observability.trace")

NAMES = [f"a{i}" for i in range(10)]
AWKWARD = ['plain', 'quote"d', "back\\slash", "new\nline", "ünïcode", ""]


def _drive(registry, seed: int) -> None:
    """A seeded sequence of instrument operations on ``registry``."""
    rng = np.random.default_rng(seed)
    c = registry.counter("t_requests_total", "Requests by \"kind\"\nand\\path", labels=("kind", "path"))
    g = registry.gauge("t_depth", "Depth")
    g2 = registry.gauge("t_version", labels=("model",))
    g3 = registry.counter("t_bytes_total", labels=("model",))
    h = registry.histogram("t_latency_seconds", "Latency", labels=("route",))
    h2 = registry.histogram("t_occ", "Occupancy", buckets=(0.5, 0.25, 1.0))
    specials = [math.nan, math.inf, -math.inf, 0.0, 1e15, 1e16, -3.0, 0.1 + 0.2, 7.0]
    for _ in range(200):
        op = int(rng.integers(6))
        lab = AWKWARD[int(rng.integers(len(AWKWARD)))]
        val = float(rng.exponential(0.3)) if rng.random() < 0.8 else specials[int(rng.integers(len(specials)))]
        if op == 0:
            c.inc(abs(val) if val == val else 1.0, kind=lab, path=str(int(rng.integers(3))))
        elif op == 1:
            g.set(val)
        elif op == 2:
            g2.set(float(rng.integers(1, 4)), model=lab)
            g3.inc(float(rng.integers(1, 4)), model=lab)
        elif op == 3:
            h.observe(val, route=lab)
        elif op == 4:
            h2.observe(val)
        elif g2.series():
            g2.remove(model=sorted(g2.series())[0][0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_text_equals_jax_byte_for_byte(seed):
    ref, out = JaxRegistry(const_labels={"host": 0, "zone": 'a"b'}), MetricsRegistry(
        const_labels={"host": 0, "zone": 'a"b'})
    _drive(ref, seed)
    _drive(out, seed)
    assert tprom.render_text(out) == jprom.render_text(ref)
    assert tprom.CONTENT_TYPE == jprom.CONTENT_TYPE


#: JAX's serve instruments that the port does not feed and so does not
#: declare: compile counts (the port has no XLA compile cache).
UNPORTED = {"ddr_compiles_total"}


def _ported(text: str) -> str:
    """JAX's exposition text without the families of :data:`UNPORTED`."""
    def name(line: str) -> str:
        if line.startswith("# "):
            return line.split(" ")[2]
        return re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)

    return "".join(line + "\n" for line in text.splitlines() if name(line) not in UNPORTED)


def test_declare_serve_metrics_first_scrape_equals_jax():
    ref, out = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    jprom.declare_serve_metrics(ref)
    tprom.declare_serve_metrics(out)
    ref_text = jprom.render_text(ref)
    assert all(f"# TYPE {n} " in ref_text for n in UNPORTED)
    assert tprom.render_text(out) == _ported(ref_text)
    # idempotent: a second declaration changes nothing
    tprom.declare_serve_metrics(out)
    assert tprom.render_text(out) == _ported(ref_text)
    # the process default registry carries the same host label as JAX's single process
    assert get_registry().const_labels == {"host": "0"}


def _events(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(120):
        kind = ["serve_request", "serve_batch", "serve_shed", "health", "other"][int(rng.integers(5))]
        net, model = f"n{int(rng.integers(2))}", ["default", 'm"x'][int(rng.integers(2))]
        if kind == "serve_request":
            status = ["ok", "ok", "shed:deadline", "shed:queue-full", "error:RuntimeError"][int(rng.integers(5))]
            out.append({"event": kind, "status": status, "network": net, "model": model,
                        "latency_s": float(rng.exponential(0.05)),
                        "queue_s": None if status == "shed:queue-full" else float(rng.exponential(0.01)),
                        **({"execute_s": float(rng.exponential(0.02))} if status == "ok" else {})})
        elif kind == "serve_batch":
            out.append({"event": kind, "network": net, "model": model, "size": int(rng.integers(1, 9)),
                        "occupancy": int(rng.integers(1, 9)) / 8, "seconds": float(rng.exponential(0.03)),
                        "queue_depth": int(rng.integers(0, 5))})
        elif kind == "serve_shed":
            out.append({"event": kind, "reason": ["queue-full", "deadline", "model-unloaded"][int(rng.integers(3))],
                        "priority": ["interactive", "batch", "bulk"][int(rng.integers(3))]})
        elif kind == "health":
            out.append({"event": kind, "reasons": [["non-finite"], ["discharge-max", "mass-residual"], []][
                int(rng.integers(3))]})
        else:
            out.append({"event": kind})
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_event_tee_equals_jax(seed):
    ref, out = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    for record in _events(seed):
        jprom.event_tee(dict(record), ref)
        tprom.event_tee(dict(record), out)
    assert tprom.render_text(out) == _ported(jprom.render_text(ref))


SUPPLIED = ["abc", "a b\tc\x00d\x7f", "ünï-cödé", "x" * 300, "  ", "\n", "", None, 0, 12345,
            "X-DDR/Req:1=ok;", "é" * 10 + "z" * 70]


@pytest.mark.parametrize("supplied", SUPPLIED, ids=range(len(SUPPLIED)))
def test_request_and_trace_ids_equal_jax(supplied):
    ours, ref = make_request_id(supplied), jax_make_request_id(supplied)
    t_ours, t_ref = ttrace.adopt_trace_id(supplied), jtrace.adopt_trace_id(supplied)
    if re.fullmatch(r"[0-9a-f]{16}", ref) and re.sub(r"[^\x21-\x7e]", "", str(supplied or "")) == "":
        # nothing usable supplied: both mint a fresh 16-hex id
        assert re.fullmatch(r"[0-9a-f]{16}", ours)
        assert re.fullmatch(r"[0-9a-f]{16}", t_ours) and re.fullmatch(r"[0-9a-f]{16}", t_ref)
    else:
        assert ours == ref and len(ours) <= 128
        assert t_ours == t_ref and len(t_ours) <= 64


def test_span_ids_and_derived_ids_equal_jax():
    """Minted span and trace ids take JAX's form, and each mint is fresh."""
    for ours, ref, form in ((ttrace.new_span_id, jtrace.new_span_id, r"[0-9a-f]{12}"),
                            (ttrace.new_trace_id, jtrace.new_trace_id, r"[0-9a-f]{16}")):
        ids = [ours() for _ in range(8)]
        assert re.fullmatch(form, ref()) and all(re.fullmatch(form, i) for i in ids)
        assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("value", [None, "1", "0", "false", " OFF ", "no", "yes", ""])
def test_trace_enabled_reads_ddr_trace_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("DDR_TRACE", raising=False)
    else:
        monkeypatch.setenv("DDR_TRACE", value)
    assert ttrace.trace_enabled() == jtrace.trace_enabled()


ENVIRONS = [
    {},
    {"DDR_SERVE_MAX_BATCH": "3", "DDR_SERVE_QUEUE_CAP": "7", "DDR_SERVE_BATCH_WAIT_MS": "12.5"},
    {"DDR_SERVE_DEADLINE_MS": "2500", "DDR_SERVE_BACKPRESSURE": "shed-by-deadline",
     "DDR_SERVE_RELOAD_POLL_MS": "500", "DDR_SERVE_HOST": "0.0.0.0", "DDR_SERVE_PORT": "0"},
    {"DDR_SERVE_HORIZON_HOURS": "24", "DDR_SERVE_PROFILE_MAX_SECONDS": "5", "DDR_SERVE_PORT": ""},
    {"DDR_SERVE_BACKPRESSURE": "shed-oldest", "DDR_OTHER": "x"},
]


@pytest.mark.parametrize("environ", ENVIRONS, ids=range(len(ENVIRONS)))
def test_serve_config_from_env_equals_jax(environ):
    ours, ref = ServeConfig.from_env(environ), JaxServeConfig.from_env(environ)
    assert ours.__dict__ == ref.__dict__
    kw = {"max_batch": 2, "reload_poll_s": 0.0}
    assert ServeConfig.from_env(environ, **kw).__dict__ == JaxServeConfig.from_env(environ, **kw).__dict__


@pytest.mark.parametrize("environ", [{"DDR_SERVE_MAX_BATCH": "two"}, {"DDR_SERVE_BACKPRESSURE": "drop"},
                                     {"DDR_SERVE_QUEUE_CAP": "0"}, {"DDR_SERVE_HORIZON_HOURS": "0"}])
def test_serve_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        JaxServeConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        ServeConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


def _stats(nonfinite=0, q_max=10.0, residual=0.0):
    return dict(nonfinite=nonfinite, q_min=0.1, q_max=q_max, mass_residual=residual)


WATCH_SEQUENCE = [
    ("observe", _stats()), ("observe", _stats(nonfinite=2)), ("observe", _stats(q_max=1e9)),
    ("observe", _stats(residual=math.nan)), ("flag", ["anomaly:queue_depth"]), ("flag", []),
    ("observe", _stats()), ("observe", _stats(nonfinite=1, q_max=1e9, residual=1e6)),
]


def test_watchdog_metrics_equal_jax():
    cfg = dict(max_discharge=1e5, max_residual=50.0, bad_batches=2)
    jreg, treg = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    ref = jh.HealthWatchdog(jh.HealthConfig(**cfg), registry=jreg)
    out = th.HealthWatchdog(th.HealthConfig(**cfg), registry=treg)
    assert tprom.render_text(treg) == _ported(jprom.render_text(jreg))
    for action, arg in WATCH_SEQUENCE:
        if action == "observe":
            r = ref.observe(jh.HealthStats(**{k: np.float32(v) for k, v in arg.items()}), network="n")
            o = out.observe(th.HealthStats(**{k: torch.tensor(v, dtype=torch.float32)
                                              for k, v in arg.items()}), network="n")
        else:
            r, o = ref.flag(arg), out.flag(arg)
        assert r == o
        assert tprom.render_text(treg) == _ported(jprom.render_text(jreg)), (action, arg)
    assert treg.get("ddr_health_status").value() == 0.0
    assert treg.get("ddr_health_violations_total").value(reason="non-finite") == 2.0


# ---- the two repairs of the port's service ----


def _tiny_service(**kw):
    basin = make_basin(n_segments=32, n_gauges=2, n_days=1, seed=1, depth=4)
    svc = ForecastService(Config(kan=KanConfig(input_var_names=NAMES)), device="cpu", **kw)
    svc.register_network("b", basin.routing_data, forcing=basin.q_prime, horizon=6)
    svc.register_model("default", Kan(NAMES, ("n", "q_spatial"), generator=torch.Generator().manual_seed(0)))
    return svc


def test_service_honours_the_serve_environment(monkeypatch):
    """A deployment's ``DDR_SERVE_*`` settings reach the service and its
    batcher when no ServeConfig is passed, as JAX's service reads them."""
    env = {"DDR_SERVE_MAX_BATCH": "3", "DDR_SERVE_QUEUE_CAP": "5", "DDR_SERVE_BACKPRESSURE": "shed-oldest",
           "DDR_SERVE_DEADLINE_MS": "1500", "DDR_SERVE_HORIZON_HOURS": "6", "DDR_SERVE_RELOAD_POLL_MS": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    svc = _tiny_service()
    try:
        assert svc.serve_cfg.__dict__ == JaxServeConfig.from_env().__dict__
        assert (svc.serve_cfg.max_batch, svc.serve_cfg.queue_cap, svc.serve_cfg.deadline_s) == (3, 5, 1.5)
        assert svc._batcher.max_batch == 3 and svc._batcher.queue_cap == 5
        assert svc._batcher.backpressure == "shed-oldest"
        assert svc.stats()["config"]["backpressure"] == "shed-oldest"
        assert svc.watch_checkpoints("default", "/nonexistent") is None  # poll 0 disables
    finally:
        svc.close()


def test_service_sanitises_a_supplied_request_id():
    svc = _tiny_service(serve_cfg=ServeConfig(max_batch=2, horizon_hours=6))
    try:
        svc.warmup()
        for supplied in ("req 1\t\x00é\x7fok", "y" * 200, " \n"):
            ans = svc.forecast(network="b", t0=0, request_id=supplied, timeout=60)
            expect = jax_make_request_id(supplied)
            if supplied.strip():
                assert ans["request_id"] == expect
            else:
                assert re.fullmatch(r"[0-9a-f]{16}", ans["request_id"])
            assert re.fullmatch(r"[\x21-\x7e]{1,128}", ans["request_id"])
    finally:
        svc.close()
