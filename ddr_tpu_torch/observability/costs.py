"""Program cards: one program's cost and memory profile, as ``ddr profile``
reports it.

The port's copy of :class:`ProgramCard` and :func:`emit_program_card` from
``ddr_tpu/observability/costs.py``. The JAX package builds its cards from
XLA's compile analyses; the port has no XLA and no compile cache, so its
cards carry the fields a torch run can measure (see :class:`ProgramCard`)
and None for the rest, and only ``ddr profile`` emits them (as
``program_card`` events): the train loop and the service emit none.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["COLLECTIVE_OPS", "ProgramCard", "emit_program_card"]

#: The collective-communication HLO opcodes a JAX card counts.
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)


@dataclasses.dataclass(frozen=True)
class ProgramCard:
    """One program's cost, memory and collective profile, with the JAX
    package's fields.

    XLA's ``cost_analysis()`` fields (``flops``, ``transcendentals``,
    ``bytes_accessed``) and ``memory_analysis()`` fields (the argument,
    output, temp, alias and generated-code bytes) have no torch counterpart
    and stay None on the port's cards, and so do the derived arithmetic
    intensity and achieved FLOP/s. ``peak_bytes`` is
    ``torch.cuda.max_memory_allocated`` over the program's first call (None
    on the CPU), ``compile_seconds`` that first call's wall (the kernels
    are built before it, so it is a warm call), ``collectives`` all zero on
    one card.
    """

    name: str
    engine: str | None = None
    platform: str | None = None
    # the routing scans the program ran ("cuda": the hand-written kernels)
    # and their compute dtype ("fp32"/"bf16")
    kernel: str | None = None
    compute_dtype: str | None = None
    # cost_analysis()
    flops: float | None = None
    transcendentals: float | None = None
    bytes_accessed: float | None = None
    # memory_analysis()
    argument_bytes: int | None = None
    output_bytes: int | None = None
    temp_bytes: int | None = None
    alias_bytes: int | None = None
    generated_code_bytes: int | None = None
    peak_bytes: int | None = None
    # collective mix a call (XLA's HLO opcodes)
    collectives: dict[str, int] = dataclasses.field(default_factory=dict)
    # input signature: "f32[48,2048]"-style specs, donation flag per argument
    input_specs: tuple[str, ...] = ()
    donated: tuple[bool, ...] = ()
    compile_seconds: float | None = None

    # ---- derived ----

    @property
    def arithmetic_intensity(self) -> float | None:
        """FLOPs per byte accessed — the roofline x-coordinate."""
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    @property
    def n_collectives(self) -> int:
        return sum(self.collectives.values())

    def achieved_flops(self, seconds: float) -> float | None:
        """FLOP/s at a measured per-execution wall time (compare against the
        device's theoretical peak for roofline placement)."""
        if not self.flops or seconds <= 0:
            return None
        return self.flops / seconds

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready dict (the ``program_card`` event payload and the
        report's card), the derived fields included."""
        d = dataclasses.asdict(self)
        d["input_specs"] = list(self.input_specs)
        d["donated"] = list(self.donated)
        d["arithmetic_intensity"] = (
            None
            if self.arithmetic_intensity is None
            else round(self.arithmetic_intensity, 4)
        )
        d["n_collectives"] = self.n_collectives
        return d


def emit_program_card(card: ProgramCard, rec: Any = None) -> None:
    """Emit one ``program_card`` event for ``card`` to ``rec`` or the active
    recorder (nothing with neither). The port has no compile events, so a
    card carries no JAX-style ``key`` joining it to one."""
    if rec is None:
        from ddr_tpu_torch.observability.events import get_recorder

        rec = get_recorder()
    if rec is not None:
        rec.emit("program_card", **card.to_dict())
