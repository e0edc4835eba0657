"""The port's numerical-health plane and recovery ladder against the JAX package.

Every health function of ``ddr_tpu_torch.observability.health`` runs on the
same arrays (made from fixed seeds with numpy, with NaNs, infinities, pad
rows, bf16 overflows and empty bands where the case needs them) as its
``ddr_tpu.observability.health`` counterpart: fp32 values within rtol 1e-5
(sums run in another order), counts exactly. ``worst_idx`` is compared as a
set where scores tie: ``torch.topk`` and ``jax.lax.top_k`` order tied
scores differently. ``HealthConfig.from_env`` reads every ``DDR_HEALTH_*``
knob as JAX does; the watchdog is driven by the same sequence of stats and
flags as the JAX watchdog (clock patched), with equal ``check``/``observe``
results, ``degraded``, ``stale`` and ``status()``. The recovery ladder's
cases are those of ``tests/observability/test_recovery.py``, and the port's
supervisor decides like JAX's over a seeded random sequence.
"""

from __future__ import annotations

import dataclasses
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.observability import health as jh
from ddr_tpu.observability import recovery as jrec
from ddr_tpu.observability.registry import MetricsRegistry
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu_torch.observability import health as th
from ddr_tpu_torch.observability import recovery as trec
from ddr_tpu_torch.routing import mc

BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def _close(ref, out, label, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    out = (out.detach().double().numpy() if torch.is_tensor(out) else np.asarray(out, np.float64))
    assert ref.shape == out.shape, label
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=0, err_msg=label)


def _same_stats(ref, out, label):
    """Every field of two HealthStats: None together, counts exact, values rtol 1e-5."""
    for f in dataclasses.fields(jh.HealthStats):
        r, o = getattr(ref, f.name), getattr(out, f.name)
        assert (r is None) == (o is None), f"{label}: {f.name}"
        if r is None or f.name in ("worst_idx", "worst_score"):
            continue
        if "nonfinite" in f.name or "overflow" in f.name:
            np.testing.assert_array_equal(np.asarray(o), np.asarray(r), err_msg=f"{label}: {f.name}")
        else:
            _close(r, o, f"{label}: {f.name}")


def _same_worst(ref_idx, ref_score, idx, score, label):
    """Scores equal; indices equal as sets above the K-th score, and any
    index at a tie with the K-th score carries that score."""
    ref_score, ref_idx = np.asarray(ref_score, np.float64), np.asarray(ref_idx)
    _close(ref_score, score, f"{label}: worst_score")
    idx, score = idx.numpy(), score.double().numpy()
    kth = ref_score[-1]
    assert set(ref_idx[ref_score > kth].tolist()) == set(idx[score > kth].tolist()), label
    assert np.all(score[np.isin(idx, ref_idx, invert=True)] == kth), label


def _field(seed, shape, nonfinite=0, overflow=0, lo=0.0, hi=50.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    flat = a.reshape(-1)
    pick = rng.choice(flat.size, size=nonfinite + overflow, replace=False)
    flat[pick[:nonfinite]] = rng.choice([np.nan, np.inf, -np.inf], size=nonfinite)
    # past the bf16 finite max, below float32's, positive: a sum of two
    # overflows to inf in any order
    flat[pick[nonfinite:]] = np.float32(3.395e38)
    return a


CASES = {
    "clean": dict(),
    "nonfinite": dict(nonfinite=5),
    "overflow": dict(overflow=3),
}


# ---- device stats ----


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["all-rows", "row-mask"])
def test_compute_health_matches_jax(case, dtype, masked):
    runoff = _field(1, (4, 12, 6), **CASES[case])
    qp = _field(2, (4, 12, 30), **CASES[case], hi=5.0)
    fd = _field(3, (4, 30), nonfinite=1 if case == "nonfinite" else 0)
    mask = np.arange(4) < 3 if masked else None
    ref = jh.compute_health(jnp.asarray(runoff), jnp.asarray(qp), final_discharge=jnp.asarray(fd),
                            row_mask=None if mask is None else jnp.asarray(mask), compute_dtype=dtype)
    out = th.compute_health(torch.as_tensor(runoff), torch.as_tensor(qp), final_discharge=torch.as_tensor(fd),
                            row_mask=None if mask is None else torch.as_tensor(mask), compute_dtype=dtype)
    _same_stats(ref, out, f"{case}/{dtype}")
    if case == "overflow" and dtype == "bf16":
        assert int(out.overflow) > 0


def test_compute_health_without_inflow_or_final_state():
    runoff = _field(4, (24, 5), nonfinite=2)
    ref = jh.compute_health(jnp.asarray(runoff), compute_dtype="bf16")
    out = th.compute_health(torch.as_tensor(runoff), compute_dtype="bf16")
    _same_stats(ref, out, "runoff only")


@pytest.mark.parametrize("case", list(CASES))
def test_compute_health_host_matches_jax_and_the_device_stats(case):
    runoff, qp = _field(5, (10, 7), **CASES[case]), _field(6, (10, 40), **CASES[case], hi=5.0)
    ref = jh.compute_health_host(runoff, qp)
    out = th.compute_health_host(runoff, qp)
    np.testing.assert_equal(dataclasses.asdict(out), dataclasses.asdict(ref))  # NaN == NaN here
    dev = th.compute_health(torch.as_tensor(runoff), torch.as_tensor(qp))
    assert int(dev.nonfinite) == out.nonfinite
    _close(out.q_max, dev.q_max, f"{case}: host vs device q_max")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_compute_reach_stats_matches_jax(case, dtype):
    rng = np.random.default_rng(7)
    runoff, qp = _field(8, (16, 50), **CASES[case]), _field(9, (16, 50), **CASES[case], hi=5.0)
    inv, qinv = rng.permutation(50), rng.permutation(50)
    ref = jh.compute_reach_stats(jnp.asarray(runoff), jnp.asarray(qp), compute_dtype=dtype,
                                 runoff_inv=jnp.asarray(inv), q_prime_inv=jnp.asarray(qinv))
    out = th.compute_reach_stats(torch.as_tensor(runoff), torch.as_tensor(qp), compute_dtype=dtype,
                                 runoff_inv=torch.as_tensor(inv), q_prime_inv=torch.as_tensor(qinv))
    for f in dataclasses.fields(jh.ReachStats):
        r, o = getattr(ref, f.name), getattr(out, f.name)
        assert (r is None) == (o is None), f.name
        if r is not None:
            _close(r, o, f"{case}/{dtype}: {f.name}")


def test_compute_reach_stats_reduces_a_batch_axis_like_stacked_time():
    """A ``(B, T, N)`` field reduces over both leading axes: the same as the
    JAX function on the ``(B*T, N)`` stack."""
    runoff, qp = _field(10, (3, 8, 20), nonfinite=2), _field(11, (3, 8, 20), hi=5.0)
    ref = jh.compute_reach_stats(jnp.asarray(runoff.reshape(24, 20)), jnp.asarray(qp.reshape(24, 20)))
    out = th.compute_reach_stats(torch.as_tensor(runoff), torch.as_tensor(qp))
    for f in ("nonfinite", "q_min", "q_max", "out_mass", "in_mass"):
        _close(getattr(ref, f), getattr(out, f), f)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["clean", "nonfinite", "empty-bands", "ties"])
def test_compute_band_health_matches_jax(case, dtype):
    rng = np.random.default_rng(12)
    n, n_bands = 60, 6
    runoff = _field(13, (10, n), nonfinite=4 if case == "nonfinite" else 0,
                    overflow=2 if dtype == "bf16" else 0)
    if case == "ties":
        runoff[:, ::3] = 7.0  # many reaches share the worst score
        runoff[0, ::3] = 9.0
    qp = _field(14, (10, n), hi=5.0)
    ids = rng.integers(0, n_bands, n).astype(np.int32)
    if case == "empty-bands":
        ids[ids >= 4] = 1  # bands 4 and 5 hold no reach
    j_reach = jh.compute_reach_stats(jnp.asarray(runoff), jnp.asarray(qp), compute_dtype=dtype)
    t_reach = th.compute_reach_stats(torch.as_tensor(runoff), torch.as_tensor(qp), compute_dtype=dtype)
    ref = jh.compute_band_health(j_reach, jnp.asarray(ids), n_bands, top_k=7, compute_dtype=dtype)
    out = th.compute_band_health(t_reach, torch.as_tensor(ids), n_bands, top_k=7, compute_dtype=dtype)
    assert set(ref) == set(out)
    for k in ref:
        if k == "worst_idx" or k == "worst_score":
            continue
        if "nonfinite" in k or "overflow" in k:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
        else:
            _close(ref[k], out[k], f"{case}/{dtype}: {k}")
    _same_worst(ref["worst_idx"], ref["worst_score"], out["worst_idx"], out["worst_score"], case)
    if case == "empty-bands":  # the JAX identities: +inf minima, -inf maxima
        assert np.all(out["band_q_min"][4:].numpy() == np.inf)
        assert np.all(out["band_q_max"][4:].numpy() == -np.inf)


@pytest.mark.parametrize("masked", [False, True], ids=["all-rows", "row-mask"])
@pytest.mark.parametrize("case", ["clean", "nonfinite"])
def test_compute_output_worst_matches_jax(case, masked):
    values = _field(15, (4, 12, 9), nonfinite=3 if case == "nonfinite" else 0)
    mask = np.arange(4) < 2 if masked else None
    ridx, rscore = jh.compute_output_worst(jnp.asarray(values), 4,
                                           row_mask=None if mask is None else jnp.asarray(mask))
    idx, score = th.compute_output_worst(torch.as_tensor(values), 4,
                                         row_mask=None if mask is None else torch.as_tensor(mask))
    assert idx.dtype == torch.int32 and idx.shape == (4,)
    _same_worst(ridx, rscore, idx, score, case)


@pytest.mark.parametrize("n_bands", [1, 4, 16, 100])
def test_band_ids_match_jax(n_bands):
    level = np.random.default_rng(16).integers(0, 31, 200).astype(np.int32)
    level[0] = 30
    ids, nb = mc.band_ids(torch.as_tensor(level), 30, n_bands)
    rids, rnb = jax_mc.band_ids(jnp.asarray(level), 30, n_bands)
    assert nb == rnb
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))


# ---- HealthConfig ----

ENV = {
    "DDR_HEALTH_ENABLED": "off", "DDR_HEALTH_MAX_NONFINITE": "3", "DDR_HEALTH_MAX_DISCHARGE": "1e5",
    "DDR_HEALTH_MAX_RESIDUAL": "40", "DDR_HEALTH_MAX_GRAD_NORM": "12.5", "DDR_HEALTH_MAX_OVERFLOW": "2",
    "DDR_HEALTH_MAX_ULP_DRIFT": "900", "DDR_HEALTH_BAD_BATCHES": "5", "DDR_HEALTH_MAX_STALL_S": "30",
    "DDR_HEALTH_BANDS": "16", "DDR_HEALTH_TOPK": "4", "DDR_HEALTH_MAX_PARAM_DRIFT": "0.5",
    "DDR_HEALTH_MAX_PARAM_OOB": "7",
}


def test_health_config_from_env_reads_every_knob_like_jax():
    out, ref = th.HealthConfig.from_env(ENV), jh.HealthConfig.from_env(ENV)
    np.testing.assert_equal(dataclasses.asdict(out), dataclasses.asdict(ref))  # NaN == NaN here
    assert [f.name for f in dataclasses.fields(th.HealthConfig)] == [
        f.name for f in dataclasses.fields(jh.HealthConfig)]
    assert out.enabled is False and out.max_ulp_drift == 900.0 and out.bands == 16
    assert dataclasses.asdict(th.HealthConfig.from_env({})) == dataclasses.asdict(jh.HealthConfig())
    assert th.HealthConfig.from_env({"DDR_HEALTH_ENABLED": "yes"}).enabled is True
    assert th.HealthConfig.from_env(ENV, bands=2).bands == 2  # overrides beat the environment


@pytest.mark.parametrize("kwargs", [{"bad_batches": 0}, {"max_nonfinite": -1}, {"max_overflow": -1},
                                    {"max_stall_s": 0.0}, {"bands": -1}, {"top_k": -1}])
def test_health_config_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        jh.HealthConfig(**kwargs)
    with pytest.raises(ValueError):
        th.HealthConfig(**kwargs)


def test_health_config_bad_env_value_names_the_variable():
    with pytest.raises(ValueError, match="DDR_HEALTH_MAX_NONFINITE"):
        th.HealthConfig.from_env({"DDR_HEALTH_MAX_NONFINITE": "many"})


# ---- the watchdog, driven like JAX's ----


def _stats(nonfinite=0, q_max=10.0, residual=0.0, grad_norm=None, overflow=None, ulp_drift=None,
           band_nonfinite=None):
    return dict(nonfinite=nonfinite, q_min=0.1, q_max=q_max, mass_residual=residual,
                grad_norm=grad_norm, overflow=overflow, ulp_drift=ulp_drift,
                band_nonfinite=band_nonfinite,
                band_q_max=None if band_nonfinite is None else [5.0] * len(band_nonfinite),
                band_residual=None if band_nonfinite is None else [0.5, -2.0, 1.0][: len(band_nonfinite)])


SEQUENCE = [
    ("observe", _stats()),
    ("observe", _stats(nonfinite=1)),
    ("observe", _stats(q_max=1e6)),
    ("observe", _stats(residual=-80.0, grad_norm=math.nan)),
    ("flag", ["param-drift"]),
    ("observe", _stats(overflow=1, ulp_drift=2000.0)),
    ("observe", _stats(ulp_drift=math.inf)),
    ("flag", ["param-drift"]),
    ("observe", _stats(band_nonfinite=[0, 2, 0])),
    ("reset", None),
    ("observe", _stats(grad_norm=3.0, overflow=0, ulp_drift=10.0)),
    ("flag", []),
    ("observe", _stats(band_nonfinite=[0, 0, 0])),
]


def _as(kind, d):
    """One stats dict as the JAX (numpy) or the port (torch) HealthStats."""
    if kind == "jax":
        return jh.HealthStats(**{k: None if v is None else np.asarray(v, np.float32) for k, v in d.items()})
    return th.HealthStats(**{k: None if v is None else torch.tensor(v, dtype=torch.float32)
                             for k, v in d.items()})


def test_watchdog_matches_jax_step_by_step(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    cfg = dict(max_discharge=1e5, max_residual=50.0, max_grad_norm=5.0, max_ulp_drift=1000.0,
               bad_batches=2, max_stall_s=30.0)
    ref = jh.HealthWatchdog(jh.HealthConfig(**cfg), registry=MetricsRegistry())
    out = th.HealthWatchdog(th.HealthConfig(**cfg))
    seen = []
    for action, arg in SEQUENCE:
        now[0] += 1.0
        if action == "observe":
            r, o = ref.observe(_as("jax", arg), batch=len(seen)), out.observe(_as("torch", arg), batch=len(seen))
            assert ref.check(_as("jax", arg)) == out.check(_as("torch", arg)) == o
        elif action == "flag":
            r, o = ref.flag(arg), out.flag(arg)
        else:
            ref.reset_streaks()
            out.reset_streaks()
            r = o = None
        assert r == o, action
        seen.append(o)
        assert ref.degraded == out.degraded and ref.consecutive_bad == out.consecutive_bad
        assert ref.status() == out.status()
    assert ["non-finite"] in seen and ["ulp-drift"] in seen and ["bf16-overflow", "ulp-drift"] in seen
    # stale after max_stall_s without a batch, cleared by the next observe
    now[0] += 31.0
    assert ref.stale and out.stale and out.degraded and ref.status() == out.status()
    out.observe(_as("torch", _stats()))
    assert not out.stale and not out.degraded


def test_disabled_watchdog_observes_nothing_and_never_goes_stale(monkeypatch):
    w = th.HealthWatchdog(th.HealthConfig(enabled=False, max_stall_s=1.0))
    assert w.observe(_as("torch", _stats(nonfinite=9))) == [] and w.flag(["x"]) == []
    now = time.monotonic() + 100.0
    monkeypatch.setattr(time, "monotonic", lambda: now)
    assert not w.stale and not w.degraded and w.status()["batches"] == 0


def test_spatial_summary_matches_jax_on_device_tensors():
    runoff, qp = _field(17, (10, 40), nonfinite=3), _field(18, (10, 40), hi=5.0)
    ids = np.random.default_rng(19).integers(0, 4, 40).astype(np.int32)
    fields = th.compute_band_health(th.compute_reach_stats(torch.as_tensor(runoff), torch.as_tensor(qp)),
                                    torch.as_tensor(ids), 4, top_k=3)
    stats = th.HealthStats(nonfinite=torch.tensor(3), q_min=torch.tensor(0.0), q_max=torch.tensor(1.0),
                           mass_residual=torch.tensor(0.0), **fields)
    jstats = jh.HealthStats(nonfinite=3, q_min=0.0, q_max=1.0, mass_residual=0.0,
                            **{k: v.numpy() for k, v in fields.items()})
    assert th.HealthWatchdog.spatial_summary(stats) == jh.HealthWatchdog.spatial_summary(jstats)


# ---- the recovery ladder (tests/observability/test_recovery.py's cases) ----


def _sup(**overrides) -> trec.RecoverySupervisor:
    return trec.RecoverySupervisor(trec.RecoveryConfig(enabled=True, **overrides))


def test_recovery_constants_match_jax():
    assert trec.RECOVERY_STAGES == jrec.RECOVERY_STAGES
    assert trec.REROUTE_REASONS == jrec.REROUTE_REASONS
    assert trec.RecoverySupervisor.MAX_QUARANTINE == jrec.RecoverySupervisor.MAX_QUARANTINE


def test_recovery_config_defaults_are_off():
    assert trec.RecoveryConfig().enabled is False
    assert trec.RecoveryConfig.from_env(environ={}).enabled is False


def test_recovery_config_from_env_reads_every_knob():
    env = {"DDR_RECOVERY_ENABLED": "1", "DDR_RECOVERY_MAX_SKIPS": "7", "DDR_RECOVERY_MAX_REROUTES": "5",
           "DDR_RECOVERY_MAX_ROLLBACKS": "2", "DDR_RECOVERY_LR_BACKOFF": "0.25"}
    cfg = trec.RecoveryConfig.from_env(environ=env)
    assert cfg == trec.RecoveryConfig(enabled=True, max_skips=7, max_reroutes=5, max_rollbacks=2,
                                      lr_backoff=0.25)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jrec.RecoveryConfig.from_env(environ=env))
    assert trec.RecoveryConfig.from_env(environ={"DDR_RECOVERY_MAX_SKIPS": "7"}, max_skips=1).max_skips == 1


@pytest.mark.parametrize("kwargs", [{"max_skips": -1}, {"max_reroutes": -1}, {"max_rollbacks": -1},
                                    {"lr_backoff": 0.0}, {"lr_backoff": 1.5}])
def test_recovery_config_bad_values_raise(kwargs):
    with pytest.raises(ValueError):
        trec.RecoveryConfig(**kwargs)


def test_recovery_config_bad_env_value_raises_with_var_name():
    with pytest.raises(ValueError, match="DDR_RECOVERY_MAX_SKIPS"):
        trec.RecoveryConfig.from_env(environ={"DDR_RECOVERY_MAX_SKIPS": "many"})


def test_bf16_reasons_reroute_first():
    sup = _sup()
    for reason in trec.REROUTE_REASONS:
        assert sup.decide([reason], fp32_available=True) == "fp32-reroute"
    assert sup.decide(list(trec.REROUTE_REASONS), fp32_available=True) == "fp32-reroute"


def test_mixed_reasons_never_reroute():
    assert _sup().decide(["bf16-overflow", "non-finite"], fp32_available=True) == "skip"


def test_no_fp32_twin_means_no_reroute():
    assert _sup().decide(["bf16-overflow"], fp32_available=False) == "skip"


def test_skip_budget_exhausted_falls_to_rollback():
    sup = _sup(max_skips=1)
    assert sup.decide(["non-finite"]) == "skip"
    sup.record("skip", ["non-finite"], epoch=1, batch=0)
    assert sup.decide(["non-finite"], rollback_available=True) == "rollback"


def test_rollback_needs_a_pinned_checkpoint():
    assert _sup(max_skips=0).decide(["non-finite"], rollback_available=False) == "give-up"


def test_full_escalation_sequence():
    sup = _sup(max_skips=1, max_reroutes=2, max_rollbacks=1)
    seen = []
    for _ in range(5):
        stage = sup.decide(["bf16-overflow"], fp32_available=True, rollback_available=True)
        seen.append(stage)
        sup.record(stage, ["bf16-overflow"], epoch=1, batch=len(seen))
    assert seen == ["fp32-reroute", "fp32-reroute", "skip", "rollback", "give-up"]


def test_decide_is_pure():
    sup = _sup(max_skips=1)
    for _ in range(5):
        assert sup.decide(["non-finite"]) == "skip"
    assert sup.count("skip") == 0


def test_record_rejects_an_unknown_stage():
    with pytest.raises(ValueError):
        _sup().record("retry-harder", ["non-finite"])


def test_skip_quarantines_the_batch_identity_within_a_bound():
    sup = _sup(max_skips=10_000)
    sup.record("skip", ["non-finite"], epoch=2, batch=5, step=13)
    assert sup.summary()["quarantined"] == [{"epoch": 2, "batch": 5}]
    for i in range(trec.RecoverySupervisor.MAX_QUARANTINE + 10):
        sup.record("skip", ["non-finite"], epoch=1, batch=i)
    assert len(sup.summary()["quarantined"]) == trec.RecoverySupervisor.MAX_QUARANTINE
    assert sup.count("skip") == trec.RecoverySupervisor.MAX_QUARANTINE + 11


def test_recoveries_totals_and_summary():
    sup = _sup()
    sup.record("skip", ["non-finite"], epoch=1, batch=0)
    sup.record("fp32-reroute", ["ulp-drift"], epoch=1, batch=1)
    assert sup.recoveries == 2
    assert sup.summary()["counts"]["skip"] == 1 and sup.summary()["enabled"] is True


def test_give_up_is_a_distinct_type():
    assert issubclass(trec.RecoveryGiveUp, RuntimeError) and trec.RecoveryGiveUp is not RuntimeError


def test_supervisor_decides_like_jax_over_a_random_sequence():
    rng = np.random.default_rng(20)
    reasons_pool = ["bf16-overflow", "ulp-drift", "non-finite", "grad-norm", "mass-residual"]
    cfg = dict(enabled=True, max_skips=3, max_reroutes=2, max_rollbacks=1)
    ours, ref = trec.RecoverySupervisor(trec.RecoveryConfig(**cfg)), jrec.RecoverySupervisor(
        jrec.RecoveryConfig(**cfg))
    for i in range(40):
        reasons = list(rng.choice(reasons_pool, size=int(rng.integers(1, 3)), replace=False))
        kw = dict(fp32_available=bool(rng.random() < 0.7), rollback_available=bool(rng.random() < 0.5))
        stage = ours.decide(reasons, **kw)
        assert stage == ref.decide(reasons, **kw)
        ours.record(stage, reasons, epoch=0, batch=i)
        ref.record(stage, reasons, epoch=0, batch=i)
    assert ours.summary() == ref.summary()
