"""Programming-cost accounting (port of :class:`repro.core.write_verify.WriteStats`).

The closed-loop write-and-verify algorithms themselves are not ported yet
(ROADMAP Queue A1); the engine bills writes with the analytic model in
:func:`repro_torch.core.crossbar.write_cost`, which returns these.
"""
from __future__ import annotations

import dataclasses

__all__ = ["WriteStats"]


@dataclasses.dataclass(frozen=True)
class WriteStats:
    """Side-channel accounting for programming cost (host scalars)."""

    energy_j: float      # total write energy (J)
    latency_s: float     # total write latency (s); rows of a pass are parallel
    iterations: int      # verify iterations used
    final_delta: float   # relative ||A_tilde - A||_p at exit

    @classmethod
    def zero(cls) -> "WriteStats":
        return cls(energy_j=0.0, latency_s=0.0, iterations=0, final_delta=0.0)

    def __add__(self, other: "WriteStats") -> "WriteStats":
        return WriteStats(
            energy_j=self.energy_j + other.energy_j,
            # Writes to distinct arrays in one pipeline are sequential per MCA.
            latency_s=self.latency_s + other.latency_s,
            iterations=self.iterations + other.iterations,
            final_delta=max(self.final_delta, other.final_delta),
        )
