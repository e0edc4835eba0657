"""``ddr profile`` on the port (``ddr_tpu_torch/scripts/profile.py``)
against the JAX package's command, on the CPU synthetic shape ``--synthetic
--n 256 --t-hours 48``.

One run of each command (the port's with ``--trace`` and ``device=cpu``,
and the KAN weights of JAX's ``build_kan`` carried across by
``kan_state_from_flax``), then:

- the same report keys, ``n``, ``t_hours``, ``depth``, ``reps`` and program
  names, and the same program-record and card field names (XLA's analyses
  None on the port, peaks None on the CPU); the markdown names every program;
- the three programs' outputs against the same programs built from the JAX
  package's functions on JAX's synthetic problem: the forward route's gauge
  runoff, the VJP's value and its gradient for each spatial parameter, and
  the train step's loss, each within rtol 1e-5 with an absolute floor of
  1e-5 x the largest magnitude (the bound of ``tests/test_torch_adjoint.py``
  and ``tests/test_torch_training.py``);
- ``--trace`` writes one Chrome trace a program;
- ``run_log.profile.jsonl`` holds one ``program_card`` event a program, with
  the keys of JAX's events;
- ``--kernel xla`` is refused by name, before any work.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.model import denormalize_spatial_parameters as jax_denormalize
from ddr_tpu.routing.model import prepare_batch as jax_prepare_batch
from ddr_tpu.scripts import profile as jprofile
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu import training as jax_training
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.scripts import profile as tprofile
from ddr_tpu_torch.scripts.common import build_kan

ARGS = ["--synthetic", "--n", "256", "--t-hours", "48", "--reps", "1"]
ENVELOPE = {"t", "wall", "pid", "seq", "host", "tags"}


def _close(ref, out, label, rtol=1e-5):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(float(np.max(np.abs(ref))), float(np.max(np.abs(out))), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5 * scale, err_msg=label)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    assert jprofile.main([*ARGS, "--out", str(root / "jax")]) == 0
    jcfg, jrd, jq, jobs, jmask = jprofile._synthetic_problem(256, 48, None)
    kan_model, jparams = jax_build_kan(jcfg)
    cfg = tprofile._synthetic_problem(256, 48, None, "cpu")[0]
    kan = build_kan(cfg, device="cpu")
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    captured = {}
    orig = tprofile.profile_programs

    def programs(*args, **kwargs):
        kwargs["kan"] = kan
        out = orig(*args, **kwargs)
        captured.update(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tprofile, "profile_programs", programs)
    try:
        assert tprofile.main([*ARGS, "--trace", "--out", str(root / "port"), "device=cpu"]) == 0
    finally:
        mp.undo()
    return {"root": root, "ours": captured, "jax_problem": (jcfg, jrd, jq, jobs, jmask),
            "jax_kan": (kan_model, jparams)}


def _report(runs, side):
    return json.loads((runs["root"] / side / "profile_report.json").read_text())


def test_report_has_jax_keys(runs):
    ours, ref = _report(runs, "port"), _report(runs, "jax")
    assert ours.keys() == ref.keys()
    for key in ("n", "t_hours", "depth", "reps", "compute_dtype", "peak_flops"):
        assert ours[key] == ref[key], key
    assert list(ours["programs"]) == list(ref["programs"]) == list(tprofile.PROGRAMS)
    assert ours["device"] == "cpu" and ours["kernel"] == "reference"
    for name in tprofile.PROGRAMS:
        mine, theirs = ours["programs"][name], ref["programs"][name]
        assert mine.keys() == theirs.keys()
        assert mine["card"].keys() == theirs["card"].keys()
        assert mine["card"]["name"] == name and mine["seconds_per_iter"] > 0 and mine["reach_timesteps_per_sec"] > 0
        assert mine["card"]["flops"] is None and mine["card"]["peak_bytes"] is None
        assert mine["card"]["collectives"].keys() == theirs["card"]["collectives"].keys()
    md = (runs["root"] / "port" / "profile_report.md").read_text()
    assert all(name in md for name in tprofile.PROGRAMS)


def test_program_card_events_have_jax_keys(runs):
    events = {}
    for side in ("port", "jax"):
        lines = (runs["root"] / side / "run_log.profile.jsonl").read_text().splitlines()
        events[side] = [json.loads(line) for line in lines]
    cards = {side: [e for e in evs if e["event"] == "program_card"] for side, evs in events.items()}
    assert [e["name"] for e in cards["port"]] == [e["name"] for e in cards["jax"]] == list(tprofile.PROGRAMS)
    for ours, ref in zip(cards["port"], cards["jax"]):
        assert set(ours) - ENVELOPE == set(ref) - ENVELOPE
    assert events["port"][-1]["event"] == "run_end" and events["port"][-1]["status"] == "ok"


def test_trace_writes_a_trace_a_program(runs):
    for name in tprofile.PROGRAMS:
        trace = runs["root"] / "port" / "profile_trace" / name / "trace.json"
        assert json.loads(trace.read_text())["traceEvents"], name


def test_programs_equal_jax(runs):
    cfg, rd, q, obs, mask = runs["jax_problem"]
    kan_model, params = runs["jax_kan"]
    ours = runs["ours"]
    p = cfg.params
    bounds = jax_mc.Bounds.from_config(p.attribute_minimums)
    network, channels, gauges = jax_prepare_batch(rd, p.attribute_minimums["slope"])
    attrs = jnp.asarray(rd.normalized_spatial_attributes)
    spatial = jax_denormalize(kan_model.apply(params, attrs), p.parameter_ranges, p.log_space_parameters,
                              p.defaults, int(rd.n_segments))
    spatial = {k: jnp.asarray(v) for k, v in spatial.items()}
    qj = jnp.asarray(q)

    runoff = jax_mc.route(network, channels, spatial, qj, gauges=gauges, bounds=bounds).runoff
    _close(runoff, ours["forward-route"]["outputs"], "forward-route runoff")

    def loss(sp):
        return jax_mc.route(network, channels, sp, qj, gauges=gauges, bounds=bounds).runoff.mean()

    value, grads = jax.jit(jax.value_and_grad(loss))(spatial)
    got_value, got_grads = ours["full-vjp"]["outputs"]
    _close(value, got_value, "full-vjp value")
    assert got_grads.keys() == grads.keys()
    for k in grads:
        _close(grads[k], got_grads[k], f"full-vjp d/d{k}")

    optimizer = jax_training.make_optimizer(1e-3)
    step = jax_training.make_batch_train_step(
        kan_model, bounds, p.parameter_ranges, p.log_space_parameters, p.defaults, tau=p.tau,
        warmup=cfg.experiment.warmup, optimizer=optimizer, donate=False,
    )
    _, _, jloss, jdaily = step(params, optimizer.init(params), network, channels, gauges, attrs, qj,
                               jnp.asarray(obs), jnp.asarray(mask))
    got_loss, got_daily = ours["train-step"]["outputs"]
    _close(jloss, got_loss, "train-step loss")
    _close(jdaily, got_daily, "train-step daily runoff")


def test_kernel_xla_is_refused_by_name(tmp_path):
    with pytest.raises(ValueError, match="--kernel xla"):
        tprofile.main([*ARGS, "--kernel", "xla", "--out", str(tmp_path), "device=cpu"])
    assert not (tmp_path / "profile_report.json").exists()
    assert tprofile.resolve_kernel("pallas") == tprofile.resolve_kernel(None) == "cuda"
