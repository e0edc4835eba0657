"""Carry the JAX package's KAN weights into the port's :class:`~ddr_tpu_torch.nn.kan.Kan`.

flax names its submodules ``Dense_0`` (input projection), ``KANLayer_<i>``
and ``Dense_1`` (output head); the port names them ``input``, ``layers.<i>``
and ``output``. A flax Dense ``kernel`` is ``(in, out)`` and a
``torch.nn.Linear`` weight ``(out, in)``, so kernels are transposed; KAN
leaves keep their shapes and are copied as they are.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["kan_state_from_flax"]


def kan_state_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A ``Kan.state_dict()``-shaped dict from a flax ``Kan`` parameter tree
    (``variables["params"]`` or the whole ``variables`` dict), leaves as numpy
    arrays or anything ``np.asarray`` takes."""
    tree = params.get("params", params)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32))

    state = {
        "input.weight": t(tree["Dense_0"]["kernel"]).T.contiguous(),
        "input.bias": t(tree["Dense_0"]["bias"]),
        "output.weight": t(tree["Dense_1"]["kernel"]).T.contiguous(),
        "output.bias": t(tree["Dense_1"]["bias"]),
    }
    i = 0
    while f"KANLayer_{i}" in tree:
        layer = tree[f"KANLayer_{i}"]
        if "knots" in layer:
            raise NotImplementedError(
                "adaptive-grid KAN layers (per-feature knots) are not ported yet (ROADMAP A.5)"
            )
        state[f"layers.{i}.w_base"] = t(layer["w_base"])
        state[f"layers.{i}.spline_coef"] = t(layer["spline_coef"])
        i += 1
    return state
