"""The fleet tier's configuration and command of the port against the JAX package's.

- ``FleetConfig.from_env`` equals JAX's over a table of environments,
  keyword overrides included, and refuses what JAX refuses with JAX's
  message; ``fleet_identity`` equals JAX's with and without the identity
  variables;
- the synthetic config ``ddr fleet up --synthetic`` writes, read by the
  port's ``yaml_subset`` reader, equals PyYAML's reading of the JAX
  command's file;
- ``fleet`` dispatches through the port's CLI (``fleet up`` and ``fleet
  status`` run in ``tests/test_torch_fleet_group.py``).
"""

from __future__ import annotations

import dataclasses

import pytest
import yaml

from ddr_tpu.fleet import config as jcfg
from ddr_tpu.scripts import fleet as jfleet
from ddr_tpu_torch import cli
from ddr_tpu_torch.fleet import config as tcfg
from ddr_tpu_torch.scripts import fleet as tfleet
from ddr_tpu_torch.validation.yaml_subset import safe_load

ENVIRONS = [
    {},
    {"DDR_FLEET_REPLICAS": "4", "DDR_FLEET_GROUP": "east", "DDR_FLEET_MODE": "subprocess"},
    {"DDR_FLEET_BASE_PORT": "9100", "DDR_FLEET_PROBE_MS": "250", "DDR_FLEET_EJECT_AFTER": "3"},
    {"DDR_FLEET_CANARY_WEIGHT": "0.25", "DDR_FLEET_CANARY_MIN_OBS": "6", "DDR_FLEET_CANARY_MARGIN": "0.1",
     "DDR_CANARY_MIN_SAMPLES": "0"},
    {"DDR_FLEET_ENSEMBLE_MAX_MEMBERS": "16", "DDR_FLEET_ENSEMBLE_SIGMA": "0.3", "DDR_FLEET_REPLICAS": "",
     "DDR_FLEET_OTHER": "x", "DDR_CANARY_MIN_SAMPLES": ""},
    {"DDR_FLEET_PROBE_MS": "1", "DDR_FLEET_CANARY_WEIGHT": "1.0"},
]


@pytest.mark.parametrize("environ", ENVIRONS, ids=range(len(ENVIRONS)))
def test_fleet_config_from_env_equals_jax(environ):
    ref, out = jcfg.FleetConfig.from_env(environ), tcfg.FleetConfig.from_env(environ)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    kw = {"replicas": 3, "mode": "inprocess", "probe_s": 0.05}
    assert (dataclasses.asdict(tcfg.FleetConfig.from_env(environ, **kw))
            == dataclasses.asdict(jcfg.FleetConfig.from_env(environ, **kw)))
    assert tcfg.FLEET_MODES == jcfg.FLEET_MODES


@pytest.mark.parametrize("environ", [
    {"DDR_FLEET_REPLICAS": "0"}, {"DDR_FLEET_REPLICAS": "two"}, {"DDR_FLEET_MODE": "threads"},
    {"DDR_FLEET_PROBE_MS": "0"}, {"DDR_FLEET_PROBE_MS": "fast"}, {"DDR_FLEET_EJECT_AFTER": "0"},
    {"DDR_FLEET_CANARY_WEIGHT": "0"}, {"DDR_FLEET_CANARY_WEIGHT": "1.5"}, {"DDR_FLEET_CANARY_MIN_OBS": "0"},
    {"DDR_CANARY_MIN_SAMPLES": "-1"}, {"DDR_CANARY_MIN_SAMPLES": "many"}, {"DDR_FLEET_BASE_PORT": "80.5"},
    {"DDR_FLEET_ENSEMBLE_SIGMA": "-0.1"},
])
def test_fleet_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        jcfg.FleetConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        tcfg.FleetConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


IDENTITIES = [
    {},
    {"DDR_FLEET_GROUP": ""},
    {"DDR_FLEET_GROUP": "east"},
    {"DDR_FLEET_GROUP": "east", "DDR_FLEET_REPLICA": "3", "DDR_FLEET_ROUTER": "local:123"},
    {"DDR_FLEET_GROUP": "g", "DDR_FLEET_REPLICA": "r-two", "DDR_FLEET_ROUTER": ""},
    {"DDR_FLEET_REPLICA": "1", "DDR_FLEET_ROUTER": "x"},
]


@pytest.mark.parametrize("environ", IDENTITIES, ids=range(len(IDENTITIES)))
def test_fleet_identity_equals_jax(environ, monkeypatch):
    assert tcfg.fleet_identity(environ) == jcfg.fleet_identity(environ)
    for k in ("DDR_FLEET_GROUP", "DDR_FLEET_REPLICA", "DDR_FLEET_ROUTER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    assert tcfg.fleet_identity() == jcfg.fleet_identity()


@pytest.mark.parametrize("segments", [64, 65536])
def test_synthetic_fleet_config_reads_as_jax(tmp_path, segments):
    """The file the port writes as text, read by ``yaml_subset``, is the
    mapping PyYAML reads from the file the JAX command dumps, for a workdir
    whose path needs quoting in YAML."""
    ours, ref = tmp_path / "port: #1", tmp_path / "jax: #1"
    ours.mkdir()
    ref.mkdir()
    got = safe_load(tfleet.synthetic_cfg_path(ours, segments).read_text())
    want = yaml.safe_load(jfleet._synthetic_cfg_path(ref, segments).read_text())
    assert got["params"]["save_path"] == str(ours / "run")
    got["params"]["save_path"] = want["params"]["save_path"]
    assert got == want


def test_cli_dispatches_fleet(capsys):
    assert "fleet" in cli._COMMANDS and "fleet" not in cli._NOT_PORTED
    assert cli.main(["fleet"]) == 2  # no subcommand: the help, as JAX's
    assert "up" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="config.yaml or --synthetic"):
        cli.main(["fleet", "up"])
