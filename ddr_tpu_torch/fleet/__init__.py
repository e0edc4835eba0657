"""The fleet tier of the port: ensemble forecasts (:mod:`.ensemble`) on the
JAX package's threefry draws (:mod:`.prng`), and the ensemble knobs of
:class:`~ddr_tpu_torch.fleet.config.FleetConfig`. The replica group, its
router and canary promotion come with ``ddr fleet`` (ROADMAP A.9)."""
