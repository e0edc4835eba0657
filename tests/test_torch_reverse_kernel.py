"""The port's reverse scan against the JAX package's ``fused_reverse_scan``.

``reverse_scan_reference`` (the plain PyTorch version of the CUDA kernel)
runs on the same reverse streams and transposed tables as
``ddr_tpu.routing.pallas_kernel.fused_reverse_scan`` (the real Pallas body,
interpreted on the CPU), one request at a time. Cases: a dendritic tree
(``t_width = 1``), a DAG with fan-out (``t_width > 1``, the slot loop runs
more than once) and ``T = 1``. The streams are built as the analytic
backward builds them (zero out of band, zero ``ow``/``duce`` at ``t = 0``).
Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the largest magnitude
(the two sum a node's successor slots in their own order).

The CUDA kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``, marked ``cuda``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.routing.pallas_kernel import fused_reverse_scan
from ddr_tpu_torch.routing.reverse_kernel import _check_tables, reverse_scan, reverse_scan_reference
from tests.test_torch_cuda import REVERSE_CASES, reverse_case


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


@pytest.mark.parametrize("name", REVERSE_CASES)
def test_reference_matches_fused_reverse_scan(name):
    net, rows_s, T = reverse_case(name)
    lams = reverse_scan_reference(rows_s, net, T=T).numpy()
    assert lams.shape == (rows_s.shape[0], T + net.depth, net.n) and np.isfinite(lams).all()
    assert np.abs(lams).max() > 0
    t_row, t_col = jnp.asarray(net.wf_t_row.numpy()), jnp.asarray(net.wf_t_col.numpy())
    for b in range(rows_s.shape[0]):
        ref = fused_reverse_scan(
            jnp.asarray(rows_s[b].numpy()), t_row, t_col, n=net.n, t_width=net.wf_t_width,
            span=net.depth, interpret=True, ring_rows=net.wf_ring_rows,
        )
        _close(ref, lams[b], f"{name}: reference vs fused_reverse_scan, request {b}")


def test_out_of_band_pairs_stay_zero():
    """Node i is in band at reverse waves ``depth - L(i) + 1 .. depth - L(i) + T``;
    elsewhere its lam is exactly 0."""
    net, rows_s, T = reverse_case("fan-out")
    lams = reverse_scan_reference(rows_s, net, T=T)
    v = torch.arange(1, T + net.depth + 1)[:, None]
    m = net.depth - net.level_p.long()[None, :]
    in_band = (v >= m + 1) & (v <= m + T)
    assert (lams[:, ~in_band] == 0).all()
    assert (lams[:, in_band] != 0).float().mean() > 0.9


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    net, rows_s, T = reverse_case("tree")
    before = reverse_scan.launches
    torch.testing.assert_close(reverse_scan(rows_s, net, T=T), reverse_scan_reference(rows_s, net, T=T),
                               rtol=0, atol=0)
    assert reverse_scan.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="CPU or CUDA"):
        reverse_scan(rows_s.to("meta"), net, T=T)


def test_table_range_check_rejects_out_of_range_slots():
    net, _, _ = reverse_case("fan-out")
    _check_tables(net)
    bad_row = dataclasses.replace(net, wf_t_row=net.wf_t_row.clone().fill_(net.wf_ring_rows - 1))
    with pytest.raises(ValueError, match="out of range"):
        _check_tables(bad_row)
    bad_col = dataclasses.replace(net, wf_t_col=net.wf_t_col.clone().fill_(net.n + 1))
    with pytest.raises(ValueError, match="out of range"):
        _check_tables(bad_col)
