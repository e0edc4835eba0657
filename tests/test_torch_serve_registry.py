"""The port's model registry and checkpoint watcher.

- ``swap_params`` is atomic: readers hammering ``get`` while weights swap
  never see a torn module, a held snapshot never changes, and the swapped-in
  module is a new object on the old one's device;
- a served batch takes one snapshot: under concurrent swaps every answer
  equals the answer of the weights its ``version`` names;
- ``check_now`` picks the newest candidate; degraded, corrupt, ``.tmp`` and
  arch-mismatched checkpoints are skipped, each warned about once, and the
  scan walks back to the newest good one (a corrupt blob is quarantined);
- a reloaded service answers what a fresh service built from the same
  checkpoint answers, bit for bit on the CPU;
- ``unregister_model`` sheds queued requests as ``model-unloaded``.

The cases mirror ``tests/serving/test_registry.py``; weights and basins come
from fixed seeds.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.observability.registry import MetricsRegistry, set_registry
from ddr_tpu_torch.serving.batcher import RequestShedError
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.registry import CheckpointWatcher, ModelRegistry
from ddr_tpu_torch.serving.service import ForecastService
from ddr_tpu_torch.training import (
    CHECKPOINT_FORMAT,
    CHECKPOINT_VERSION,
    checkpoint_degraded,
    load_state,
    save_state,
)
from ddr_tpu_torch.validation.configs import Config, KanConfig

NAMES = [f"a{i}" for i in range(10)]
ARCH = {"model": "kan", "hidden_size": 11}
HORIZON = 12


def _kan(seed: int = 0) -> Kan:
    return Kan(NAMES, ("n", "q_spatial"), generator=torch.Generator().manual_seed(seed))


def _stamped(stamp: float) -> dict:
    """A state dict whose every float tensor holds ``stamp``: a torn read
    (old tensor beside new) shows as two values."""
    return {k: np.full(v.shape, stamp, np.float32) if v.is_floating_point() else v.numpy()
            for k, v in _kan().state_dict().items()}


def _stamps(kan: torch.nn.Module) -> set[float]:
    return {float(v.flatten()[0]) for v in kan.state_dict().values() if v.is_floating_point()} | {
        float(v.max()) for v in kan.state_dict().values() if v.is_floating_point()}


@pytest.fixture(autouse=True)
def _fresh_metrics():
    set_registry(MetricsRegistry(const_labels={"host": 0}))
    yield
    set_registry(None)


def test_register_get_swap_versions():
    reg = ModelRegistry()
    kan = _kan()
    before = {k: v.clone() for k, v in kan.state_dict().items()}
    reg.register("m", kan, arch=ARCH)
    e = reg.get("m")
    assert e.version == 1 and e.arch == ARCH and e.kan is kan and not kan.training
    e2 = reg.swap_params("m", _stamped(2.0), source="ckpt2")
    assert e2.version == 2 and e2.source == "ckpt2" and e2.arch == ARCH
    assert e2.kan is not kan and _stamps(e2.kan) == {2.0} and not e2.kan.training
    assert next(e2.kan.parameters()).device == next(kan.parameters()).device
    # the served module was never written in place
    assert all(torch.equal(before[k], v) for k, v in kan.state_dict().items())
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", _kan())
    with pytest.raises(KeyError):
        reg.get("nope")
    with pytest.raises(KeyError):
        reg.swap_params("nope", _stamped(1.0))
    with pytest.raises(RuntimeError):  # another architecture's state dict
        reg.swap_params("m", {"w": np.zeros(3, np.float32)})
    assert reg.get("m").version == 2
    assert reg.names() == ["m"] and reg.unregister("m").version == 2 and reg.names() == []


def test_concurrent_readers_never_see_torn_weights():
    reg = ModelRegistry()
    reg.register("m", _kan())
    reg.swap_params("m", _stamped(0.0))
    stop = threading.Event()
    torn, held = [], []

    def reader():
        while not stop.is_set():
            e = reg.get("m")
            stamps = _stamps(e.kan)
            if len(stamps) != 1:
                torn.append(stamps)
            held.append((e, stamps))

    threads = [threading.Thread(target=reader) for _ in range(8)]
    for t in threads:
        t.start()
    for stamp in range(1, 100):
        reg.swap_params("m", _stamped(float(stamp)))
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not torn and reg.get("m").version == 101
    # a held snapshot never changes after the reader took it
    assert all(_stamps(e.kan) == stamps for e, stamps in held[::50])


def _payloads(seed: int, n: int) -> list[np.ndarray]:
    """Storm-like inflow windows: a steady inflow routes to the same runoff
    whatever the weights, so these vary hour to hour."""
    rng = np.random.default_rng(seed)
    return [rng.gamma(0.5, 2.0, size=(HORIZON, 48)).astype(np.float32) for _ in range(n)]


def _service(tmp_path=None, **serve_kw):
    basin = make_basin(n_segments=48, n_gauges=3, n_days=2, seed=2, depth=6)
    serve_kw.setdefault("max_batch", 3)
    serve_kw.setdefault("horizon_hours", HORIZON)
    svc = ForecastService(Config(kan=KanConfig(input_var_names=NAMES)), ServeConfig(**serve_kw), device="cpu")
    svc.register_network("b", basin.routing_data, forcing=basin.q_prime)
    return svc


def _close(ref, out) -> bool:
    scale = max(np.abs(ref).max(), np.abs(out).max(), 1e-8)
    return bool(np.allclose(out, ref, rtol=1e-5, atol=1e-5 * scale))


def test_a_batch_takes_one_snapshot_while_weights_swap():
    """Requests are served while another thread swaps among three weight sets;
    version v holds set (v - 1) % 3. Every answer equals the answer of the
    set its version names, so no batch mixed two versions."""
    sets = [_kan(s).state_dict() for s in (0, 1, 2)]
    svc = _service(batch_wait_s=0.002)
    try:
        svc.register_model("default", _kan(0))
        svc.warmup()
        payloads = _payloads(3, 12)
        order = [int(i) for i in np.random.default_rng(3).integers(0, len(payloads), size=48)]
        stop = threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                i += 1
                svc.registry.swap_params("default", sets[i % 3])
                time.sleep(0.001)

        w = threading.Thread(target=writer)
        w.start()
        try:
            answers = [f.result(timeout=120) for f in [svc.submit("b", q_prime=payloads[i]) for i in order]]
        finally:
            stop.set()
            w.join(timeout=10)
        versions = {a["version"] for a in answers}
        assert len(versions) > 1, "the swaps never overlapped the traffic"
        # the reference answer of each set, served alone with no swap running
        ref = {}
        for k in range(3):
            svc.registry.swap_params("default", sets[k])
            for i in set(order):
                ref[(k, i)] = svc.forecast(network="b", q_prime=payloads[i], timeout=60)["runoff"]
        # one batch's rows may round 1 ulp apart from the same request served
        # alone (the CPU's vectorised sums see another batch); the three sets
        # lie far farther apart than the tolerance
        for i, a in zip(order, answers):
            near = [k for k in range(3) if _close(ref[(k, i)], a["runoff"])]
            assert near == [(a["version"] - 1) % 3], (a["version"], near)
    finally:
        svc.close()


def _save(directory, epoch: int, seed: int = 1, arch=ARCH, healthy=None):
    return save_state(directory, "serve", epoch, 0, _kan(seed), None, arch=arch, healthy=healthy)


def _watched(tmp_path, arch=ARCH) -> tuple[ModelRegistry, CheckpointWatcher]:
    reg = ModelRegistry()
    reg.register("m", _kan(), arch=arch)
    return reg, CheckpointWatcher(registry=reg, name="m", directory=tmp_path, expected_arch=arch, poll_s=60)


def test_check_now_picks_the_newest_candidate_once(tmp_path):
    reg, w = _watched(tmp_path)
    assert not w.check_now()  # empty: nothing to load
    paths = [_save(tmp_path, epoch, seed=epoch) for epoch in (1, 3, 2)]
    os.utime(paths[0], (time.time() + 50, time.time() + 50))  # mtime breaks ties only
    assert w.check_now()
    e = reg.get("m")
    assert e.version == 2 and e.source == str(paths[1])
    assert all(torch.equal(a, b) for a, b in zip(e.kan.state_dict().values(), _kan(3).state_dict().values()))
    assert not w.check_now() and reg.get("m").version == 2  # same file: no re-swap
    assert all(p.exists() for p in paths)  # the watcher never deletes checkpoints


def test_bad_checkpoints_are_skipped_once_each_and_the_scan_walks_back(tmp_path, caplog):
    reg, w = _watched(tmp_path)
    good = _save(tmp_path, 1, seed=1)
    assert w.check_now() and reg.get("m").source == str(good)
    # a degraded checkpoint and a leftover .tmp: the scan walks back to the good one
    degraded = _save(tmp_path, 2, seed=2, healthy=False)
    assert checkpoint_degraded(degraded) is True and checkpoint_degraded(good) is None
    (tmp_path / "_serve_epoch_9_mb_0.pkl.tmp").write_bytes(b"half a write")
    with caplog.at_level("WARNING"):
        assert not w.check_now() and not w.check_now()
    assert caplog.text.count("saved while training was degraded") == 1
    assert reg.get("m").version == 2
    # a corrupt blob (bit flip after its manifest) is quarantined, and the next
    # scans land on the good one again, which is already loaded: no new version
    corrupt = _save(tmp_path, 3, seed=3)
    data = bytearray(corrupt.read_bytes())
    data[len(data) // 2] ^= 0xFF
    corrupt.write_bytes(bytes(data))
    caplog.clear()
    with caplog.at_level("WARNING"):
        assert not w.check_now() and not w.check_now() and not w.check_now()
    assert caplog.text.count("not loadable") == 1 and not corrupt.exists()
    assert (tmp_path / (corrupt.name + ".corrupt")).exists()
    assert reg.get("m").version == 2 and reg.get("m").source == str(good)
    # another architecture: refused, logged once, the current weights keep serving
    _save(tmp_path, 4, seed=4, arch={**ARCH, "hidden_size": 5})
    caplog.clear()
    with caplog.at_level("WARNING"):
        assert not w.check_now() and not w.check_now()
    assert caplog.text.count("different architecture") == 1
    assert reg.get("m").version == 2 and reg.get("m").source == str(good)
    # a healthy newer one loads
    newest = _save(tmp_path, 5, seed=5, healthy=True)
    assert w.check_now() and reg.get("m").version == 3 and reg.get("m").source == str(newest)


def test_a_foreign_blob_is_refused(tmp_path):
    import pickle

    reg, w = _watched(tmp_path)
    blob = {"format": "something-else", "version": CHECKPOINT_VERSION, "epoch": 1, "mini_batch": 0,
            "params": {}, "opt_state": {}}
    (tmp_path / "_other_epoch_1_mb_0.pkl").write_bytes(pickle.dumps(blob))
    assert not w.check_now() and reg.get("m").version == 1
    assert CHECKPOINT_FORMAT != "something-else"


def test_a_reloaded_service_answers_as_a_fresh_one(tmp_path):
    """The watcher thread of the service picks a checkpoint up (the metrics
    count it), and the reloaded service then answers what a service built
    from that checkpoint answers."""
    svc = _service(reload_poll_s=0.05)
    fresh = _service()
    try:
        svc.register_model("default", _kan(0), arch=ARCH)
        watcher = svc.watch_checkpoints("default", tmp_path)
        svc.warmup()
        q = _payloads(8, 1)[0]
        before = svc.forecast(network="b", q_prime=q, timeout=60)
        path = _save(tmp_path, 1, seed=7)
        deadline = time.monotonic() + 30
        while svc.registry.get("default").version == 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        after = svc.forecast(network="b", q_prime=q, timeout=60)
        assert after["version"] == 2 and svc.models_info()["default"]["source"] == str(path)
        assert svc.metrics.get("ddr_hot_reloads_total").value(model="default") == 1
        assert svc.metrics.get("ddr_model_version").value(model="default") == 2

        kan = _kan(99)
        params = load_state(path, expected_arch=ARCH)["params"]
        kan.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        fresh.register_model("default", kan, arch=ARCH)
        fresh.warmup()
        ref = fresh.forecast(network="b", q_prime=q, timeout=60)
        np.testing.assert_array_equal(after["runoff"], ref["runoff"])
        assert not np.array_equal(after["runoff"], before["runoff"])
    finally:
        svc.close()
        fresh.close()
    assert not watcher.is_alive()


def test_unregister_model_sheds_queued_requests():
    entered, gate = threading.Event(), threading.Event()
    svc = _service(max_batch=1, batch_wait_s=0.0)
    try:
        svc.register_model("default", _kan(0))
        svc.register_model("other", _kan(1))
        svc.warmup()
        run = svc._run_batch

        def blocked(*args, **kw):
            entered.set()
            gate.wait(timeout=30)
            return run(*args, **kw)

        svc._run_batch = blocked
        first = svc.submit("b", model="other", t0=0)
        assert entered.wait(timeout=30)
        queued = [svc.submit("b", model="default", t0=t, priority=p)
                  for t, p in ((1, "bulk"), (2, "interactive"))]
        kept = svc.submit("b", model="other", t0=3)
        svc.unregister_model("default")
        gate.set()
        for f in queued:
            with pytest.raises(RequestShedError) as e:
                f.result(timeout=30)
            assert e.value.reason == "model-unloaded"
        assert first.result(timeout=30)["model"] == kept.result(timeout=30)["model"] == "other"
        assert svc.stats()["queue"]["shed_by_class"] == {"model-unloaded/bulk": 1,
                                                         "model-unloaded/interactive": 1}
        assert svc.metrics.get("ddr_serve_shed_total").value(reason="model-unloaded", priority="bulk") == 1
        assert ("default",) not in svc.metrics.get("ddr_model_version").series()
        assert list(svc.models_info()) == ["other"]
        with pytest.raises(KeyError):
            svc.submit("b", model="default", t0=0)
    finally:
        svc.close()
