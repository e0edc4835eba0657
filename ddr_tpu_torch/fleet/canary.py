"""Skill-gated canary promotion: a weighted request split between a ``stable``
and a ``candidate`` model, with a bounded state machine deciding the rollout.

The port of ``ddr_tpu/fleet/canary.py``. Promotion is a traffic decision,
not a deploy: both models are registered (and warm) on one
:class:`~ddr_tpu_torch.serving.service.ForecastService`, and the controller
only chooses which arm answers each request. The evidence is hydrologic
skill: observation-carrying requests feed per-arm
:class:`~ddr_tpu_torch.observability.skill.SkillTracker` instances, and the
arms' median NSE is what the state machine compares; ensemble arms add
CRPS evidence through per-arm
:class:`~ddr_tpu_torch.observability.verification.VerificationScorer`
instances. Both live on private registries, apart from the service's.

States (strictly forward, two terminal; the machine is bounded):

- ``shadow``: stable answers every request; observation-carrying requests
  also run the candidate on the same inputs (shadow traffic), so it accrues
  skill without being seen;
- ``canary``: a deterministic ``weight`` fraction of requests (a hash of the
  request id, so a request always lands on the same arm) is answered by the
  candidate;
- ``promoted``: the candidate answers everything (terminal);
- ``rolled-back``: stable answers everything (terminal), entered from any
  live state when the candidate's median NSE falls more than ``margin``
  below stable's, or when the service's health watchdog degrades.

Every transition is one ``canary`` event through the service's ``_emit``,
carrying the per-arm evidence that forced it.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Any

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["CanaryController", "STATES"]

#: The bounded state machine; the last two are terminal.
STATES = ("shadow", "canary", "promoted", "rolled-back")


def _arm_fraction(request_id: str) -> float:
    """Deterministic [0, 1) split coordinate for one request id (stable hash,
    not ``hash()`` — arm routing must not depend on PYTHONHASHSEED)."""
    digest = hashlib.sha1(f"arm|{request_id}".encode()).digest()
    return int.from_bytes(digest[:4], "big") / 2**32


class CanaryController:
    """Route requests between two registered models and decide promotion."""

    def __init__(
        self,
        service: Any,
        stable: str = "default",
        candidate: str = "candidate",
        fleet_cfg: Any = None,
        weight: float | None = None,
        min_obs: int | None = None,
        margin: float | None = None,
        min_samples: int | None = None,
    ) -> None:
        from ddr_tpu_torch.fleet.config import FleetConfig
        from ddr_tpu_torch.observability.registry import MetricsRegistry
        from ddr_tpu_torch.observability.skill import SkillConfig, SkillTracker
        from ddr_tpu_torch.observability.verification import (
            VerificationScorer,
            VerifyConfig,
        )

        cfg = fleet_cfg or FleetConfig.from_env()
        self._svc = service
        self.stable = str(stable)
        self.candidate = str(candidate)
        if self.stable == self.candidate:
            raise ValueError("stable and candidate must be different models")
        service.registry.get(self.stable)  # raise early on unknown models
        service.registry.get(self.candidate)
        self.weight = cfg.canary_weight if weight is None else float(weight)
        self.min_obs = cfg.canary_min_obs if min_obs is None else int(min_obs)
        self.margin = cfg.canary_margin if margin is None else float(margin)
        self.min_samples = (
            cfg.canary_min_samples if min_samples is None else int(min_samples)
        )
        if not 0.0 < self.weight <= 1.0:
            raise ValueError(f"weight must be in (0, 1], got {self.weight}")
        # per-arm trackers get PRIVATE registries: the arms' skill
        # distributions must not mix with each other (or with the service's
        # ddr_skill_* series) — the canary event carries the comparison
        skill_cfg = SkillConfig.from_env(enabled=True)
        self._trackers = {
            "stable": SkillTracker(skill_cfg, registry=MetricsRegistry()),
            "candidate": SkillTracker(skill_cfg, registry=MetricsRegistry()),
        }
        # per-arm verification scorers (same privacy rule): ensemble arms
        # accrue CRPS evidence through observe_ensemble, and when both arms
        # carry enough MATCHED samples the state machine compares proper
        # scores instead of point-metric NSE
        verify_cfg = VerifyConfig.from_env(enabled=True)
        self._scorers = {
            "stable": VerificationScorer(verify_cfg, registry=MetricsRegistry()),
            "candidate": VerificationScorer(verify_cfg, registry=MetricsRegistry()),
        }
        self._ens_obs = {"stable": 0, "candidate": 0}
        self._lock = threading.Lock()
        self._state = "shadow"
        self._canary_entry_obs = 0  # candidate obs count when canary started
        self._transitions: list[dict] = []
        self._shadow_failures = 0
        self._shadow_fail_counter = service.metrics.counter(
            "ddr_canary_shadow_failures_total",
            "Shadow-arm forecasts dropped because the candidate errored "
            "(the stable answer was still returned)",
            labels=("model",),
        )

    # ---- routing ----

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def arm_for(self, request_id: str) -> str:
        """Which arm answers this request id in the CURRENT state."""
        state = self.state
        if state == "promoted":
            return "candidate"
        if state == "canary" and _arm_fraction(request_id) < self.weight:
            return "candidate"
        return "stable"  # shadow / rolled-back / the stable canary fraction

    def handle(
        self,
        observations: Any | None = None,
        gauge_ids: Any | None = None,
        timeout: float | None = None,
        **request: Any,
    ) -> dict:
        """One routed forecast. ``observations`` (a ``(T, G)`` array matching
        the response's gauge columns, NaN = missing) makes this request
        skill-bearing: the serving arm's tracker is fed, in ``shadow`` the
        candidate additionally runs the same inputs as shadow traffic, and
        the state machine re-evaluates. The result dict gains ``arm`` and
        ``canary_state``."""
        from ddr_tpu_torch.serving.service import make_request_id

        rid = make_request_id(request.pop("request_id", None))
        arm = self.arm_for(rid)
        model = self.candidate if arm == "candidate" else self.stable
        result = self._svc.forecast(
            timeout=timeout, model=model, request_id=rid, **request
        )
        if observations is not None:
            obs = np.asarray(observations, dtype=np.float64)
            self.observe(arm, result["runoff"], obs, gauge_ids)
            if self.state == "shadow":
                # shadow traffic: the candidate sees the same inputs, scored
                # against the same observations, invisible to the caller —
                # INCLUDING its failures. Shadow doubles observation-carrying
                # traffic, so under overload the extra forecast is the one
                # most likely to be shed/rejected; the stable arm already
                # answered, and that answer must not be lost to the copy.
                try:
                    shadow = self._svc.forecast(
                        timeout=timeout, model=self.candidate,
                        request_id=f"{rid}-shadow", **request,
                    )
                    self.observe("candidate", shadow["runoff"], obs, gauge_ids)
                except Exception as e:
                    with self._lock:
                        self._shadow_failures += 1
                    self._shadow_fail_counter.inc(model=self.candidate)
                    log.warning(
                        f"shadow forecast for candidate {self.candidate!r} "
                        f"dropped ({type(e).__name__}: {e}); the candidate "
                        "loses one observation, the caller keeps the stable "
                        "answer"
                    )
            self.evaluate()
        out = dict(result)
        out["arm"] = arm
        out["canary_state"] = self.state
        return out

    def observe(
        self, arm: str, pred: Any, obs: Any, gauge_ids: Any | None = None
    ) -> None:
        """Feed one arm's tracker directly (the shadow-eval / replay path —
        anything that holds matched predictions and observations)."""
        tracker = self._trackers[arm]
        pred = np.atleast_2d(np.asarray(pred, dtype=np.float64))
        if gauge_ids is None:
            gauge_ids = [str(i) for i in range(pred.shape[1])]
        tracker.observe(pred, obs, gauge_ids, arm=arm)

    def observe_ensemble(
        self,
        arm: str,
        members: Any,
        obs: Any,
        gauge_ids: Any | None = None,
        lead_h: Any | None = None,
    ) -> None:
        """Feed one arm's verification scorer: an ``(E, T, G)`` member stack
        matched against ``(T, G)`` observations (NaN = missing). This is the
        CRPS evidence path for ensemble arms — once both arms hold
        ``min_samples`` matched samples, :meth:`evaluate` compares proper
        scores instead of median NSE. ``lead_h`` defaults to hourly steps
        1..T (a forecast issued now, verified over its horizon)."""
        scorer = self._scorers[arm]
        members = np.asarray(members, dtype=np.float64)
        if members.ndim == 2:
            members = members[None, :, :]
        obs = np.atleast_2d(np.asarray(obs, dtype=np.float64))
        _E, T, G = members.shape
        if gauge_ids is None:
            gauge_ids = [str(i) for i in range(G)]
        if lead_h is None:
            lead_h = np.arange(1, T + 1, dtype=np.float64)
        scorer.update(members, obs, lead_h, gauge_ids)
        with self._lock:
            self._ens_obs[arm] += 1

    # ---- the state machine ----

    def _evidence(self) -> dict:
        rollup = {}
        for arm, tracker in self._trackers.items():
            status = tracker.status()
            sc_status = self._scorers[arm].status()
            scores = sc_status.get("scores") or {}
            with self._lock:
                ens_obs = self._ens_obs[arm]
            rollup[arm] = {
                # batches seen (skill-bearing requests + ensemble joins) —
                # the min_obs cadence gate
                "observations": int(status.get("observations", 0)) + ens_obs,
                # scored (pred, obs) pairs — the DDR_CANARY_MIN_SAMPLES floor
                "samples": int(status.get("samples", 0)),
                "matched_samples": int(sc_status.get("samples", 0)),
                "nse_median": (status.get("nse") or {}).get("median"),
                "crps_mean": scores.get("crps"),
            }
        return rollup

    def evaluate(self) -> str:
        """Re-run the promotion decision; returns the (possibly new) state.

        Transition rules, evaluated once BOTH arms carry at least ``min_obs``
        observation batches AND at least ``min_samples`` scored (pred, obs)
        pairs (``DDR_CANARY_MIN_SAMPLES`` — skill samples + matched
        verification samples; a transition must never fire off a near-empty
        window). Evidence preference: when both arms hold ``min_samples``
        MATCHED verification samples, the comparison is mean CRPS (the proper
        score — ensemble arms are judged as distributions); otherwise median
        NSE. A candidate worse than stable by more than ``margin`` (relative
        for CRPS, absolute for NSE) rolls back; parity or better advances
        shadow -> canary; canary -> promoted after the candidate accrues
        ``min_obs`` MORE observations while actually taking weighted traffic
        (shadow evidence alone never promotes). A degraded health watchdog
        rolls back from any live state regardless of skill and regardless of
        the sample floor — numerics failing under candidate traffic is a
        safety stop, not an evidence question."""
        evidence = self._evidence()
        with self._lock:
            state = self._state
            if state in ("promoted", "rolled-back"):
                return state
            if self._svc.watchdog.degraded:
                return self._transition_locked(
                    "rolled-back", "watchdog-degraded", evidence
                )
            cand, stab = evidence["candidate"], evidence["stable"]
            if min(cand["observations"], stab["observations"]) < self.min_obs:
                return state
            if min(
                cand["samples"] + cand["matched_samples"],
                stab["samples"] + stab["matched_samples"],
            ) < self.min_samples:
                return state
            c_crps, s_crps = cand["crps_mean"], stab["crps_mean"]
            use_crps = (
                c_crps is not None
                and s_crps is not None
                and min(cand["matched_samples"], stab["matched_samples"])
                >= self.min_samples
            )
            if use_crps:
                # CRPS is smaller-is-better and scale-bearing (discharge
                # units), so the margin is RELATIVE
                if c_crps > s_crps * (1.0 + self.margin):
                    return self._transition_locked(
                        "rolled-back", "crps-regression", evidence
                    )
                parity, confirmed = "crps-parity", "crps-confirmed"
            else:
                c_nse, s_nse = cand["nse_median"], stab["nse_median"]
                if c_nse is None or s_nse is None:
                    return state
                if c_nse < s_nse - self.margin:
                    return self._transition_locked(
                        "rolled-back", "skill-regression", evidence
                    )
                parity, confirmed = "skill-parity", "skill-confirmed"
            if state == "shadow":
                self._canary_entry_obs = cand["observations"]
                return self._transition_locked("canary", parity, evidence)
            if cand["observations"] - self._canary_entry_obs >= self.min_obs:
                return self._transition_locked("promoted", confirmed, evidence)
            return state

    def _transition_locked(self, to: str, reason: str, evidence: dict) -> str:
        """One state-machine edge (caller holds the lock): record it and emit
        the ``canary`` event. Emission happens inline — the recorder path is
        non-blocking and a transition must never be observable before its
        event exists."""
        record = {
            "state_from": self._state,
            "state_to": to,
            "reason": reason,
            "weight": self.weight,
            "stable_model": self.stable,
            "candidate_model": self.candidate,
            "stable_obs": evidence["stable"]["observations"],
            "candidate_obs": evidence["candidate"]["observations"],
            "stable_samples": evidence["stable"]["samples"],
            "candidate_samples": evidence["candidate"]["samples"],
            "stable_matched": evidence["stable"]["matched_samples"],
            "candidate_matched": evidence["candidate"]["matched_samples"],
            "stable_nse": evidence["stable"]["nse_median"],
            "candidate_nse": evidence["candidate"]["nse_median"],
            "stable_crps": evidence["stable"]["crps_mean"],
            "candidate_crps": evidence["candidate"]["crps_mean"],
        }
        self._state = to
        self._transitions.append(record)
        log.info(
            f"canary {record['state_from']} -> {to} ({reason}): "
            f"candidate nse {record['candidate_nse']} vs "
            f"stable {record['stable_nse']}"
        )
        self._svc._emit("canary", **record)
        return to

    def status(self) -> dict:
        """Controller rollup: state, knobs, per-arm evidence, transition log."""
        evidence = self._evidence()
        with self._lock:
            return {
                "state": self._state,
                "stable": self.stable,
                "candidate": self.candidate,
                "weight": self.weight,
                "min_obs": self.min_obs,
                "min_samples": self.min_samples,
                "margin": self.margin,
                "arms": evidence,
                "shadow_failures": self._shadow_failures,
                "transitions": list(self._transitions),
            }
