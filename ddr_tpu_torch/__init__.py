"""PyTorch/CUDA port of ``ddr_tpu``: differentiable Muskingum-Cunge routing
with a KAN parameter network, served on an NVIDIA Hopper card.

The package mirrors ``ddr_tpu``'s module paths so each counterpart is easy to
find, imports ``torch`` and ``numpy`` only (never ``jax`` and nothing of
``ddr_tpu``), and keeps the JAX package's public layouts: time-major
``(T, N)`` / ``(B, T, N)`` discharge, ``wf_perm`` order inside the wavefront
engine. Entry points take an explicit ``device`` that defaults to ``"cuda"``
and raise when no card is present unless the caller asks for ``"cpu"``.

This slice covers the serving path: network tables, MC physics, the
forward wavefront engine with its hand-written CUDA wave-scan kernel
(``routing/wave_kernel.py`` + ``csrc/wave_scan.cu``), the KAN, and a minimal
``ForecastService``. Training (the analytic adjoint and the reverse-scan
kernel) is a later slice.
"""
