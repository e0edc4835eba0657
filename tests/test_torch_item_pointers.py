"""The port's messages about what it skips or refuses name the right cause:
the train loop's validation plots are skipped because the card machine has
no matplotlib (as ``ddr test`` and ``ddr route`` say), and per-feature KAN
knots are refused as ROADMAP A.5, the item that ports them (as the config
reader says)."""

from __future__ import annotations

import numpy as np
import pytest

from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.scripts import router, test, train
from ddr_tpu_torch.validation.configs import load_config


def test_skipped_plots_name_matplotlib():
    assert "validation plots (they need matplotlib)" in train.TELEMETRY_ABSENT
    assert "A.7" not in train.TELEMETRY_ABSENT
    for message in (test.TEST_PARTS_ABSENT, router.ROUTE_PARTS_ABSENT):
        assert "matplotlib" in message


def test_per_feature_knots_name_their_item():
    leaf = np.zeros((2, 3), np.float32)
    tree = {"Dense_0": {"kernel": leaf, "bias": leaf[0]}, "Dense_1": {"kernel": leaf.T, "bias": leaf[:, 0]},
            "KANLayer_0": {"w_base": leaf, "spline_coef": leaf, "knots": leaf}}
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.5"):
        kan_state_from_flax(tree)
    with pytest.raises(NotImplementedError, match=r"A\.5"):
        load_config("examples/synthetic/config.yaml", ["kan.adaptive_grid=true"], save_config=False)
