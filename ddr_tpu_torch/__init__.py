"""PyTorch/CUDA port of ``ddr_tpu``: differentiable Muskingum-Cunge routing
with a KAN parameter network, served on an NVIDIA Hopper card.

The package mirrors ``ddr_tpu``'s module paths so each counterpart is easy to
find, imports ``torch`` and ``numpy`` only (never ``jax`` and nothing of
``ddr_tpu``), and keeps the JAX package's public layouts: time-major
``(T, N)`` / ``(B, T, N)`` discharge, ``wf_perm`` order inside the wavefront
engine. Entry points take an explicit ``device`` that defaults to ``"cuda"``
and raise when no card is present unless the caller asks for ``"cpu"``.

It covers the serving path (network tables, MC physics, the forward
wavefront engine with its hand-written CUDA wave-scan kernel,
``routing/wave_kernel.py`` + ``csrc/wave_scan.cu``, the KAN and a minimal
``ForecastService``), one train step (the analytic adjoint with its
hand-written reverse-scan kernel, ``routing/reverse_kernel.py`` +
``csrc/reverse_scan.cu``), networks beyond the single-ring caps through
the stacked band router (``routing/stacked.py``), whose bands run both
kernels, and bf16 routing (the forward kernel's bf16-ring instantiation)
with the numerical-health stats, watchdog and recovery supervisor that gate
it (``observability/``).
"""
