"""The port's config reader and loader against the JAX package's.

The port reads YAML with its own reader (``ddr_tpu_torch/validation/
yaml_subset.py``) and validates on dataclasses; the JAX package reads with
PyYAML and validates with pydantic. Held here, exactly (validated values
compared as their JSON dumps):

* the reader against ``yaml.safe_load`` on the repo's example configs and
  on documents that use each construct of the subset, PyYAML's quirks
  included (``1e-3`` stays a string, ``1.0e-3`` is a float, ``yes``/``off``
  are bools, ``1981/10/01`` stays a string);
* ``load_config`` against JAX's on ``examples/synthetic/config.yaml`` and
  ``examples/merit_basin/config.yaml``, alone and under override strings
  (ints, floats, ``1e-3``, bools, ``null``, lists, flow maps, dates), and
  on an ``include:`` + ``${...}`` composition;
* the errors both raise, and those only the port raises (anchors and block
  scalars in the reader; ``kan.adaptive_grid``, ``experiment.parallel``,
  ``device: tpu``);
* the saved ``pydantic_config.yaml`` (JSON), which ``yaml.safe_load`` reads
  back and JAX's ``Config`` validates to the same values.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import yaml

from ddr_tpu.validation import configs as jax_configs
from ddr_tpu_torch.validation import configs
from ddr_tpu_torch.validation.yaml_subset import YamlSubsetError, safe_load

ROOT = Path(__file__).resolve().parents[1]
SYNTHETIC = ROOT / "examples/synthetic/config.yaml"
MERIT = ROOT / "examples/merit_basin/config.yaml"

DOCUMENTS = [
    SYNTHETIC.read_text(),
    MERIT.read_text(),
    (
        "a: 1\nb: 1e-3\nc: 1.0e-3\nd: 1.0e3\ne: yes\nf: off\ng: 1981/10/01\nh: ~\ni:\n"
        "j: 'x''y'\nk: \"a\\tb\\u00e9\"\nl: 0x1F\nm: 017\nn: 1_000\no: .inf\np: -.INF\nq: +5\n"
        "r: 0b101\ns: hello world # comment\nt: 'a # b'\nu: ${oc.env:HOME,/x}\nv: .5\nw: 3.14e+2\n"
        "x: [1, 2.5, three, [4, 5], {a: 1}]\ny: {1: 0.01, 2: 0.003, x: [a, b]}\nz: -1\n"
        "On: No\nNULL: Off\n"
    ),
    (
        "top:\n  - a\n  - b: 1\n    c: 2\n  -\n    - x\n    - y\nsame:\n- 1\n- 2\n"
        "nested:\n  deep:\n    deeper: [1,\n      2, 3]\n  empty_list: []\n  empty_map: {}\n"
    ),
    "--- \na: 1\n",
    "# only a comment\n",
]
OVERRIDE_VALUES = [
    "0.01", "[1,2]", "{1: 0.1}", "null", "", "true", "hello world", "1e-3", "-1.5", "x: y",
    "'quoted'", "[a, 'b c', \"d\"]", "1.", "Yes", "1981/10/01",
]
OVERRIDES = [
    [],
    ["experiment.epochs=3", "experiment.batch_size=4.0", "np_seed=7", "seed=3"],
    ["experiment.learning_rate={1: 1e-3, 2: 1.0e-3, 4: 2}", "experiment.warmup=1"],
    ["kan.grid_range=[-1.5, 2]", "kan.learnable_parameters=[n, q_spatial, p_spatial]"],
    ["experiment.shuffle=no", "data_sources.is_hourly=on", "experiment.remat_bands=true"],
    ["experiment.max_area_diff_sqkm=null", "experiment.checkpoint=/tmp/ck/_x_epoch_1_mb_0.pkl"],
    ["experiment.max_area_diff_sqkm=1e-3", "params.attribute_minimums.slope=1e-4"],
    ["experiment.start_time=1981/10/05", "experiment.end_time=1982/01/15", "experiment.rho=10"],
    ["synthetic_segments=128", "synthetic_depth=16", "params.tau=2", "name= renamed "],
    ["experiment.adjoint=analytic", "experiment.prefetch_ahead=3", "params.save_path=out/run"],
    ["experiment.test_start_time=1995/10/01", "data_sources.gages=g.csv",
     "data_sources.target_catchments=[cat-1, cat-2]"],
]
# raised by both loaders
BAD_OVERRIDES = [
    "experiment.foo=1", "experiment.epochs=1.5", "kan.grid_range=[2, 1]", "kan.grid_range=[1]",
    "experiment.adjoint=bad", "experiment.parallel=bogus", "synthetic_segments=0", "name=5",
    "experiment.prefetch_ahead=0", "kan.grid_update_epochs=[1]", "mode=flying",
    "experiment.shuffle=maybe", "kan.input_var_names=[1, 2]", "params.tau=x", "experiment=3",
]


def _same(got, want) -> bool:
    """Equal, NaN equal to NaN, types kept (1 and 1.0 and True differ)."""
    if isinstance(want, float) and isinstance(got, float) and math.isnan(want):
        return math.isnan(got)
    if type(got) is not type(want):
        return False
    if isinstance(want, dict):
        return list(got) == list(want) and all(_same(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(_same(g, w) for g, w in zip(got, want))
    return got == want


@pytest.mark.parametrize("i", range(len(DOCUMENTS)))
def test_reader_matches_pyyaml_on_documents(i):
    doc = DOCUMENTS[i]
    assert _same(safe_load(doc), yaml.safe_load(doc)), doc


@pytest.mark.parametrize("value", OVERRIDE_VALUES)
def test_reader_matches_pyyaml_on_override_values(value):
    assert _same(safe_load(value), yaml.safe_load(value))


@pytest.mark.parametrize("doc", [
    "a: &x 1\nb: *x", "a: |\n  text\n", "a: >\n  folded\n", "a: !!str 1", "a: 2001-12-14",
    "a: 1:30", "<<: {a: 1}", "a: 1\na: 2", "--- \na: 1\n---\nb: 2\n", "k: a b: c",
])
def test_reader_refuses_what_is_outside_the_subset(doc):
    with pytest.raises(YamlSubsetError):
        safe_load(doc)


def _jax(path, overrides, **kw):
    return json.loads(jax_configs.load_config(path, overrides, save_config=False, **kw).model_dump_json())


def _port(path, overrides, **kw):
    return json.loads(configs.load_config(path, overrides, save_config=False, **kw).model_dump_json())


@pytest.mark.parametrize("path", [SYNTHETIC, MERIT], ids=["synthetic", "merit"])
@pytest.mark.parametrize("k", range(len(OVERRIDES)))
def test_load_config_matches_jax(path, k):
    overrides = ["device=cpu", *OVERRIDES[k]]
    assert _same(_port(path, overrides), _jax(path, overrides))


@pytest.mark.parametrize("override", BAD_OVERRIDES)
def test_both_loaders_refuse(override):
    with pytest.raises(ValueError):
        jax_configs.load_config(SYNTHETIC, ["device=cpu", override], save_config=False)
    with pytest.raises(ValueError):
        configs.load_config(SYNTHETIC, ["device=cpu", override], save_config=False)


@pytest.mark.parametrize("override,error,item", [
    ("kan.adaptive_grid=true", NotImplementedError, "A.5"),
    ("experiment.parallel=auto", NotImplementedError, "A.13"),
    ("device=cpu:8", NotImplementedError, "A.13"),
    ("device=tpu", ValueError, "'cuda'"),
])
def test_port_refuses_what_it_does_not_have(override, error, item):
    with pytest.raises(error, match=item):
        configs.load_config(SYNTHETIC, [override], save_config=False)


def test_device_defaults_to_the_card():
    assert configs.load_config(SYNTHETIC, save_config=False).device == "cuda"


def test_include_and_interpolation_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_TEST_SAVE", str(tmp_path / "runs"))
    (tmp_path / "base.yaml").write_text(
        "kan:\n  input_var_names: [a0, a1]\n  hidden_size: 5\nexperiment:\n  epochs: 4\n"
        "params:\n  save_path: ${oc.env:DDR_TEST_SAVE}\n"
    )
    (tmp_path / "run.yaml").write_text(
        "include: [base.yaml]\nname: composed\ngeodataset: synthetic\nmode: training\n"
        "experiment:\n  rho: 5\n  warmup: ${experiment.rho}\nrun_note: 'save ${params.save_path}'\n"
    )
    raw_port = configs.load_raw_config(tmp_path / "run.yaml", ["experiment.batch_size=2"])
    raw_jax = jax_configs.load_raw_config(tmp_path / "run.yaml", ["experiment.batch_size=2"])
    assert _same(raw_port, raw_jax)
    raw_port.pop("run_note")
    assert _same(json.loads(configs.validate_config(raw_port).model_dump_json()),
                 json.loads(jax_configs.validate_config(dict(raw_port, device="cpu")).model_dump_json())
                 | {"device": "cuda"})


def test_saved_config_reads_back_in_jax(tmp_path):
    cfg = configs.load_config(SYNTHETIC, ["device=cpu", f"params.save_path={tmp_path}",
                                          "experiment.learning_rate={1: 1e-3}"])
    saved = yaml.safe_load((tmp_path / "pydantic_config.yaml").read_text())
    assert _same(saved, json.loads(cfg.model_dump_json()))
    assert _same(json.loads(jax_configs.Config(**saved).model_dump_json()), saved)
