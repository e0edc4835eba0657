"""Linear time-invariant (LTI) impulse-response river routing: the port of
``ddr_tpu/benchmarks/irf.py``, the comparator of ``ddr benchmark``.

Every reach is a linear channel with impulse response h_i, and discharge is
the network-composed convolution

    Q_i = h_i * (q'_i + sum_{j drains into i} Q_j).

An rFFT over (zero-padded) time turns it into one complex lower-triangular
system per frequency bin,

    (I - diag(ĥ_f) N) Q̂_f = diag(ĥ_f) q̂'_f,

which :func:`~ddr_tpu_torch.routing.solver.solve_lower_triangular` solves in
complex64, a chunk of bins at a time over the leading axis. The solve is
plain PyTorch, as the JAX package's is plain XLA outside any Pallas kernel.

The IRF families and their formulas are the JAX package's; every kernel is
normalised to unit mass, so routing conserves volume in the discrete sense.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.solver import solve_lower_triangular

__all__ = ["IRF_FAMILIES", "irf_kernels", "route_lti"]

#: Reaches a forward or inverse FFT of :func:`route_lti` takes at a time.
REACH_BATCH = 8192

IRF_FAMILIES = ("muskingum", "linear_storage", "nash_cascade", "pure_lag", "hayami")


def irf_kernels(
    irf_fn: str,
    k: np.ndarray,
    x: np.ndarray,
    dt: float,
    max_delay: int,
    nash_n: int = 3,
) -> np.ndarray:
    """Discrete per-reach impulse-response kernels, shape ``(N, max_delay)``.

    Parameters
    ----------
    irf_fn:
        One of :data:`IRF_FAMILIES`.
    k:
        (N,) wave travel time per reach, in the same units as ``dt`` (days in the
        benchmark config; DiffRoute's RAPID default is 0.1042 d = 9000 s).
    x:
        (N,) Muskingum weighting / dimensionless-diffusivity factor in [0, 0.5).
    dt:
        Timestep in the same units as ``k``.
    max_delay:
        Kernel length in timesteps (DiffRoute ``max_delay``).

    Kernel formulas (t sampled at bin midpoints, then renormalized to unit mass):

    - ``muskingum``: the linear Muskingum channel transfer function
      ``H(s) = (1 - Kxs) / (1 + K(1-x)s)`` — an instantaneous spike
      ``-x/(1-x) δ(t)`` plus ``exp(-t / K(1-x)) / (K(1-x)^2)``.
    - ``linear_storage``: single linear reservoir, ``exp(-t/k)/k``.
    - ``nash_cascade``: ``nash_n`` equal reservoirs with total mean delay ``k``
      (gamma density, shape ``nash_n``, scale ``k/nash_n``).
    - ``pure_lag``: unit spike at ``t = k``.
    - ``hayami``: diffusive-wave (inverse-Gaussian) kernel with mean ``k`` and
      shape ``λ = k/(2x)`` — ``x → 0`` approaches pure translation, larger ``x``
      more dispersion.
    """
    if irf_fn not in IRF_FAMILIES:
        raise ValueError(f"irf_fn {irf_fn!r} not in {IRF_FAMILIES}")
    k = np.maximum(np.asarray(k, np.float64), 1e-6)[:, None]  # (N, 1)
    x = np.clip(np.asarray(x, np.float64), 0.0, 0.499)[:, None]
    n = k.shape[0]
    t = (np.arange(max_delay, dtype=np.float64) + 0.5)[None, :] * dt  # bin midpoints

    edges = np.arange(max_delay + 1, dtype=np.float64)[None, :] * dt  # bin edges

    if irf_fn == "muskingum":
        # Exact per-bin integrals of the exponential component (midpoint sampling
        # loses the mass entirely when K(1-x) << dt), plus the -x/(1-x) spike.
        a = k * (1.0 - x)
        cdf = np.exp(-edges / a)
        h = (cdf[:, :-1] - cdf[:, 1:]) / (1.0 - x)
        h[:, 0] += -(x / (1.0 - x))[:, 0]
    elif irf_fn == "linear_storage":
        cdf = np.exp(-edges / k)
        h = cdf[:, :-1] - cdf[:, 1:]
    elif irf_fn == "nash_cascade":
        scale = k / nash_n
        h = (
            t ** (nash_n - 1)
            * np.exp(-t / scale)
            / (scale**nash_n * math.gamma(nash_n))
            * dt
        )
    elif irf_fn == "pure_lag":
        h = np.zeros((n, max_delay))
        idx = np.clip(np.round(k[:, 0] / dt).astype(int), 0, max_delay - 1)
        h[np.arange(n), idx] = 1.0
    else:  # hayami
        lam = k / (2.0 * x + 1e-6)
        h = (
            np.sqrt(lam / (2.0 * np.pi * t**3))
            * np.exp(-lam * (t - k) ** 2 / (2.0 * k**2 * t))
            * dt
        )

    # Degenerate-kernel guard: when the response narrows below one bin (k << dt, or
    # x -> 0 for hayami), midpoint sampling underflows to an all-zero kernel, which
    # would silently annihilate all flow through the reach in route_lti; a muskingum
    # kernel truncated far short of its travel time can even net negative mass, which
    # normalization would sign-flip. Substitute the narrow-kernel limit in either
    # case: a unit spike at t = k.
    degenerate = h.sum(axis=1) < 1e-6
    if degenerate.any():
        idx = np.clip(np.round(k[:, 0] / dt).astype(int), 0, max_delay - 1)
        h[degenerate] = 0.0
        h[degenerate, idx[degenerate]] = 1.0

    return (h / h.sum(axis=1, keepdims=True)).astype(np.float32)


def _next_pow2(v: int) -> int:
    return 1 << (int(v) - 1).bit_length()


def route_lti(
    network: RiverNetwork,
    kernels: np.ndarray | torch.Tensor,
    q_prime: torch.Tensor,
    pad_steps: int | None = None,
    freq_batch: int = 256,
) -> torch.Tensor:
    """Route ``(T, N)`` lateral inflows through per-reach LTI channels on
    ``q_prime``'s device; returns the ``(T, N)`` discharge at every reach.

    ``pad_steps`` zero-padding bounds the FFT's circular wrap; the default
    scales with network depth (a path through D reaches has a mean delay of
    about D times a reach's), at least ``8 * max_delay``. The frequency bins
    are solved ``freq_batch`` at a time, and the forward and inverse FFTs run
    :data:`REACH_BATCH` reaches at a time into two ``(F, N)`` complex64
    spectra, the kernels' and the inflow's, which the solve overwrites; the
    peak holds those two and chunk-sized temporaries."""
    T, n = q_prime.shape
    if n != network.n:
        raise ValueError(f"q_prime has {n} reaches, network has {network.n}")
    dev = q_prime.device
    kernels = torch.as_tensor(kernels, dtype=torch.float32, device=dev)
    q_prime = q_prime.to(torch.float32)
    if pad_steps is None:
        # composed tail length ~ depth * mean per-reach delay (kernels sum to 1)
        delays = torch.arange(kernels.shape[1], dtype=torch.float32, device=dev)
        mean_delay = float((kernels * delays).sum(1).mean())
        pad_steps = int(max(8 * kernels.shape[1], network.depth * mean_delay + 4 * kernels.shape[1]))
    n_fft = _next_pow2(T + pad_steps)
    F = n_fft // 2 + 1

    h_hat = torch.empty(F, n, dtype=torch.complex64, device=dev)
    spec = torch.empty(F, n, dtype=torch.complex64, device=dev)
    for s in range(0, n, REACH_BATCH):
        h_hat[:, s : s + REACH_BATCH] = torch.fft.rfft(kernels[s : s + REACH_BATCH], n=n_fft, dim=1).T
        spec[:, s : s + REACH_BATCH] = torch.fft.rfft(q_prime[:, s : s + REACH_BATCH], n=n_fft, dim=0)
    with torch.no_grad():
        for f in range(0, F, freq_batch):
            h_f = h_hat[f : f + freq_batch]
            spec[f : f + freq_batch] = solve_lower_triangular(network, h_f, h_f * spec[f : f + freq_batch])
    del h_hat
    q = torch.empty(T, n, dtype=torch.float32, device=dev)
    for s in range(0, n, REACH_BATCH):
        q[:, s : s + REACH_BATCH] = torch.fft.irfft(spec[:, s : s + REACH_BATCH], n=n_fft, dim=0)[:T]
    return q
