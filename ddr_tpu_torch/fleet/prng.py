"""Threefry-2x32 keys and float32 normals with JAX's bits.

The ensemble tier seeds each member's forcing perturbation from the request
id, and the JAX package draws it with ``jax.random`` (``PRNGKey``,
``fold_in``, ``normal``) under ``jax_threefry_partitionable=True``. This
module computes the same draws with torch tensor arithmetic, so a request id
gives the same members in both packages and on any device:

- a key is two uint32 words ``(k1, k2)``; ``prng_key(seed)`` of a seed below
  2**32 is ``(0, seed)``;
- ``fold_in(key, m)`` hashes the counter pair ``(0, m)`` under ``key``;
- ``random_bits(key, n)`` hashes the counter pairs ``(0, i)`` for the
  row-major flat index ``i`` and XORs the two output words (the partitionable
  layout);
- ``normal(key, shape)`` maps the top 23 bits to a uniform in
  ``[nextafter(-1, 0), 1)`` and returns ``sqrt(2) * erfinv(u)`` in float32,
  with ``erfinv`` evaluated as XLA evaluates it in float32 (M. Giles'
  polynomials, "Approximating the erfinv function", 2010), not with
  ``torch.erfinv``: XLA's float32 ``erfinv`` is up to ~50 ulp from the
  correctly rounded value, so ``torch.erfinv`` would leave normals 6e-6 apart
  relatively.

The uint32 words live in int64 tensors masked to 32 bits (torch has no
unsigned 32-bit arithmetic on every device). The bits equal JAX's exactly;
the normals differ from JAX's by at most a few ulp, where ``log1p`` or the
polynomial's roundings differ.
"""

from __future__ import annotations

import math

import torch

__all__ = ["erfinv32", "fold_in", "normal", "prng_key", "random_bits", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32 constants of ``jax.random.normal``: the uniform's lower end
#: nextafter(-1, 0), its span computed in float32 (1 - lo rounds to 2), and sqrt(2).
_LO = -0.99999994039535522
_SPAN = 2.0
_SQRT2 = math.sqrt(2.0)
#: Values hashed at a time by :func:`normal`: its int64 temporaries stay a
#: few times this wide whatever the shape.
_CHUNK = 1 << 24
_LOG1P_SMALL = 0.41421356237309504880  # sqrt(2) - 1
#: Giles' coefficients for w = -log1p(-u*u) below 5 and from 5 on, highest degree first.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                  -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                  -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``."""
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return 0, seed


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    (int64 tensors holding uint32 values) under ``key``."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK], dtype=torch.int64))
    return int(y0[0]), int(y1[0])


def random_bits(key: tuple[int, int], n: int, device: str | torch.device = "cpu",
                start: int = 0) -> torch.Tensor:
    """JAX's 32-bit random bits of flat indices ``start .. start + n - 1``
    (of an array of fewer than 2**32 values), as int64 in ``[0, 2**32)``."""
    count = torch.arange(start, start + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(count), count)
    return y0 ^ y1


def _horner(coefficients: tuple[float, ...], w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coefficients[0])
    for c in coefficients[1:]:
        p = c + p * w
    return p


def erfinv32(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erfinv`` (``u`` in ``[-1, 1]``, float32). Its
    ``log1p(x)`` is ``log(1 + x)`` for ``|x|`` from sqrt(2) - 1 on, with the
    sum rounded, as XLA emits it; a true ``log1p`` there would move ``w``
    across 5, and so change polynomials, for a few values in 10^5."""
    x = -u * u
    w = -torch.where(x.abs() < _LOG1P_SMALL, torch.log1p(x), torch.log(1.0 + x))
    small = w < 5.0
    p = torch.where(small, _horner(_ERFINV_W_LT_5, w - 2.5), _horner(_ERFINV_W_GE_5, torch.sqrt(w) - 3.0))
    return torch.where(u.abs() == 1.0, u * math.inf, p * u)


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(floats * _SPAN + _LO, _LO)
    return erfinv32(u) * _SQRT2


def normal(key: tuple[int, int], shape: tuple[int, ...], device: str | torch.device = "cpu",
           out: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32, into ``out`` when given."""
    n = math.prod(shape)
    flat = torch.empty(n, dtype=torch.float32, device=device) if out is None else out.view(-1)
    for lo in range(0, n, _CHUNK):
        flat[lo : lo + _CHUNK] = _normal_from_bits(random_bits(key, min(_CHUNK, n - lo), device, lo))
    return flat.view(shape)
