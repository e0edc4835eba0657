"""The port's fault injection (``ddr_tpu_torch/observability/faults.py``)
against the JAX package's on the same specs: the parsed plans, the errors
for bad specs, the firing sequence of a probabilistic plan under
``DDR_FAULTS_SEED``, the bytes ``_flip_bits`` writes, the arrays
``_poison_array`` writes (NaN patterns compared exactly) and the ``fault``
events. Every comparison is exact."""

from __future__ import annotations

import json

import numpy as np
import pytest

from ddr_tpu.observability import events as jax_events
from ddr_tpu.observability import faults as jax_faults
from ddr_tpu_torch.observability import events as port_events
from ddr_tpu_torch.observability import faults as port_faults

SPECS = [
    "crash@step=37;slow@data.load:p=0.1,ms=500;corrupt@checkpoint.write:n=1",
    " crash@step=1 ; ; slow@load:ms=5 ;",
    "nan@data.forcings=1:n=1;nan@device.step=1:n=1;nan@device.grads=2:n=1",
    "crash@execute:p=0.25;crash@reload:at=3",
    "slow@data.remote_read:ms=1,n=2",
]
BAD_SPECS = [
    "crash@nowhere",  # unknown site
    "explode@step",  # unknown action
    "crash@step:bogus=1",  # unknown parameter
    "crashstep",  # no @
    "crash@step:p",  # a parameter without =
    "crash@step:p=2.0",  # a probability out of range
    "corrupt@device.step",  # no byte payload to flip
    "corrupt@serve.execute",
    "nan@checkpoint.write",  # no float array to poison
    "nan@registry.reload",
    "crash@data",  # ambiguous suffix
]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jax_faults.configure(None)
    port_faults.configure(None)


def test_vocabularies_equal_jax():
    for name in ("FAULT_SITES", "FAULT_ACTIONS", "PAYLOAD_SITES", "NAN_SITES"):
        assert getattr(port_faults, name) == getattr(jax_faults, name), name


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_plans_equal_jax(spec):
    for seed in (0, 7):
        want = jax_faults.FaultPlan(jax_faults.parse_faults(spec, seed=seed)).describe()
        got = port_faults.FaultPlan(port_faults.parse_faults(spec, seed=seed)).describe()
        assert got == want
        assert [a.describe() for a in port_faults.parse_faults(spec)] == [
            a.describe() for a in jax_faults.parse_faults(spec)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_faults(spec)
    with pytest.raises(ValueError) as got:
        port_faults.parse_faults(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_probabilistic_firing_sequence_equals_jax(monkeypatch, seed):
    """A ``p=0.3`` plan over 1,000 invocations, seeded through
    ``DDR_FAULTS_SEED`` and parsed from ``DDR_FAULTS`` as a run parses it."""
    spec = "slow@data.load:p=0.3;crash@device.step:p=0.3,n=50"
    monkeypatch.setenv("DDR_FAULTS", spec)
    monkeypatch.setenv("DDR_FAULTS_SEED", str(seed))
    sequences = []
    for module in (jax_faults, port_faults):
        monkeypatch.setattr(module, "_PLAN", None)
        plan = module.active_plan()
        fired = []
        for site in ("data.load", "device.step"):
            (action,) = plan._by_site[site]
            fired.append([action.should_fire({}) for _ in range(1000)])
        sequences.append(fired)
    assert sequences[0] == sequences[1]
    assert 200 < sum(sequences[1][0]) < 400  # p = 0.3 over 1,000 calls
    assert sum(sequences[1][1]) == 50  # n caps the firings


@pytest.mark.parametrize("size", [0, 1, 96, 97, 98, 1000])
def test_flip_bits_equals_jax(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    got = port_faults._flip_bits(data)
    assert got == jax_faults._flip_bits(data)
    assert (got != data) == (size > 0)


@pytest.mark.parametrize("shape,dtype", [((5,), np.float32), ((24, 7), np.float32), ((3, 4, 5), np.float64),
                                         ((0,), np.float32), ((6,), np.int32), ((4, 3), np.complex64)])
def test_poison_array_equals_jax(shape, dtype):
    rng = np.random.default_rng(11)
    arr = rng.normal(size=shape).astype(dtype)
    src = arr.copy()
    got, want = port_faults._poison_array(arr), jax_faults._poison_array(arr)
    np.testing.assert_array_equal(got, want)  # NaN where NaN, inf where inf
    np.testing.assert_array_equal(arr, src)  # the caller's array is never touched
    if np.issubdtype(dtype, np.floating) and arr.size:
        assert np.isinf(got.flat[0]) and np.isnan(got).sum() == (arr.size - 1) // 3


def test_poison_array_on_a_non_contiguous_view():
    base = np.arange(48, dtype=np.float32).reshape(6, 8)
    view = base[:, ::2].T
    np.testing.assert_array_equal(port_faults._poison_array(view), jax_faults._poison_array(view))


def _run_points(faults_mod, events_mod, tmp_path, label):
    (tmp_path / label).mkdir()
    rec = events_mod.Recorder(tmp_path / label / "log.jsonl")
    events_mod.activate(rec)
    try:
        faults_mod.configure("corrupt@checkpoint.write:n=1;nan@device.step=2;slow@data.load:ms=1,n=2;"
                             "crash@execute=1")
        out = {}
        out["write"] = faults_mod.maybe_inject("checkpoint.write", data=b"x" * 200, path="p", epoch=1,
                                               mini_batch=0)
        out["write2"] = faults_mod.maybe_inject("checkpoint.write", data=b"y" * 10)
        step = faults_mod.fault_site("device.step")
        arr = np.ones((4, 3), np.float32)
        out["steps"] = [step(arr, step=s, epoch=1, batch=s) for s in range(4)]
        load = faults_mod.fault_site("data.load")
        for b in range(3):
            load(epoch=1, batch=b)
        execute = faults_mod.fault_site("serve.execute")
        execute(network="n", model="m", size=2)
        with pytest.raises(faults_mod.InjectedFault) as crash:
            execute(network="n", model="m", size=3)
        out["crash"] = (crash.value.site, str(crash.value))
        assert faults_mod.fault_site("registry.reload") is None
    finally:
        events_mod.deactivate()
        rec.close()
    lines = [json.loads(line) for line in (tmp_path / label / "log.jsonl").read_text().splitlines()]
    return out, [{k: v for k, v in e.items() if k not in ("ts", "wall", "seq", "pid", "host", "t")}
                 for e in lines if e["event"] == "fault"]


def test_fault_points_and_events_equal_jax(tmp_path):
    want, want_events = _run_points(jax_faults, jax_events, tmp_path, "jax")
    got, got_events = _run_points(port_faults, port_events, tmp_path, "port")
    assert got["write"] == want["write"] != b"x" * 200
    assert got["write2"] == want["write2"] == b"y" * 10  # n=1: the second write passes
    for g, w in zip(got["steps"], want["steps"]):
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got["steps"][2]).any() and np.isfinite(got["steps"][1]).all()
    assert got["crash"] == want["crash"] == ("serve.execute", "injected fault: crash@serve.execute")
    assert got_events == want_events
    assert [e["site"] for e in got_events] == ["checkpoint.write", "device.step", "data.load", "data.load",
                                              "serve.execute"]


def test_unset_plan_arms_nothing(monkeypatch):
    monkeypatch.delenv("DDR_FAULTS", raising=False)
    monkeypatch.setattr(port_faults, "_PLAN", None)
    assert all(port_faults.fault_site(s) is None for s in port_faults.FAULT_SITES)
    assert port_faults.maybe_inject("checkpoint.write", data=b"abc") == b"abc"
    with pytest.raises(ValueError, match="unknown fault site"):
        port_faults.fault_site("device.nowhere")


def _log(tmp_path) -> list[dict]:
    return [json.loads(line) for path in sorted(tmp_path.glob("run_log.*.jsonl"))
            for line in path.read_text().splitlines()]


def test_serve_execute_crash_rides_the_error_path(tmp_path):
    """``crash@serve.execute``, resolved when the service is built: the
    batch's futures fail with the injected fault, each request still gets a
    terminal ``serve_request`` event, and the next batch is served."""
    from ddr_tpu_torch.scripts.loadtest import build_synthetic_service

    port_faults.configure("crash@serve.execute:n=1")
    service, cfg = build_synthetic_service(32, 6, save_path=str(tmp_path), overrides=["device=cpu"],
                                           serve_overrides={"max_batch": 2})
    try:
        with port_events.run_telemetry(cfg, "serve", base_dir=str(tmp_path)):
            first = [service.submit("default", t0=t) for t in (0, 1)]
            errors = []
            for f in first:
                with pytest.raises(port_faults.InjectedFault) as e:
                    f.result(timeout=60)
                errors.append(e.value.site)
            answer = service.submit("default", t0=2).result(timeout=60)
    finally:
        service.close(drain=False)
    assert errors == ["serve.execute", "serve.execute"]
    assert np.isfinite(answer["runoff"]).all()
    events = _log(tmp_path)
    assert [e["status"] for e in events if e["event"] == "serve_request"] == [
        "error:InjectedFault", "error:InjectedFault", "ok"]
    (fault,) = [e for e in events if e["event"] == "fault"]
    assert (fault["site"], fault["action"], fault["network"], fault["model"], fault["size"]) == (
        "serve.execute", "crash", "default", "default", 2)


def test_registry_reload_crash_keeps_the_current_weights(tmp_path):
    """``crash@registry.reload``: the watcher's load is refused, the served
    weights stay, and the next checkpoint (the plan spent) is swapped in."""
    import torch

    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.serving.registry import CheckpointWatcher, ModelRegistry
    from ddr_tpu_torch.training import save_state

    def kan(seed):
        return Kan(("a0", "a1"), ("n", "q_spatial"), hidden_size=3, generator=torch.Generator().manual_seed(seed))

    reg = ModelRegistry()
    reg.register("m", kan(0))
    watcher = CheckpointWatcher(registry=reg, name="m", directory=tmp_path, expected_arch=None, poll_s=60)
    port_faults.configure("crash@registry.reload:n=1")
    save_state(tmp_path, "serve", 1, 0, kan(1), None)
    assert not watcher.check_now() and reg.get("m").version == 1
    save_state(tmp_path, "serve", 2, 0, kan(2), None)
    assert watcher.check_now() and reg.get("m").version == 2
    assert all(torch.equal(a, b) for a, b in zip(reg.get("m").kan.state_dict().values(),
                                                 kan(2).state_dict().values()))
