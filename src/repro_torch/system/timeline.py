"""``Timeline``: one run's simulated clock, beside the byte ledger.

The port's copy of the reference's ``repro.system.timeline``. The round
loop emits one simulated round time and the deadline casualty counts per
round, and the engine assembles them into a Timeline on the host. Where
``CommLedger`` answers "what did the run cost in bytes", a Timeline
answers "what did it cost in seconds"; joined with a metric history it
gives time-to-accuracy curves (``FLResult.sim_seconds``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Timeline"]


@dataclass
class Timeline:
    """Per-round simulated durations and deadline drops.

    profile: the SystemSpec's name (presentation).
    round_seconds: simulated duration of each global round.
    dropped_teams / dropped_devices: per-round counts of participants
        removed by the straggler deadline (all zeros without one).
    """
    profile: str = ""
    round_seconds: list = field(default_factory=list)
    dropped_teams: list = field(default_factory=list)
    dropped_devices: list = field(default_factory=list)

    def __len__(self):
        return len(self.round_seconds)

    def total_seconds(self) -> float:
        """Simulated wall clock of the whole run."""
        return float(np.sum(self.round_seconds))

    def cum_seconds(self) -> np.ndarray:
        """Cumulative simulated time after each round (non-decreasing:
        round durations are positive)."""
        return np.cumsum(np.asarray(self.round_seconds, dtype=np.float64))

    def at_rounds(self, points) -> list:
        """Cumulative simulated seconds at each 1-based round index (pass
        ``repro_torch.train.engine.eval_points(rounds, eval_every)``)."""
        cum = self.cum_seconds()
        return [float(cum[p - 1]) for p in points]

    def stragglers(self) -> int:
        """Total device drops across the run (deadline casualties)."""
        return int(np.sum(self.dropped_devices))

    def summary(self) -> dict:
        """Flat dict of totals."""
        rs = np.asarray(self.round_seconds, dtype=np.float64)
        return {"profile": self.profile,
                "rounds": len(self),
                "sim_seconds": float(rs.sum()),
                "mean_round_seconds": float(rs.mean()) if len(rs) else 0.0,
                "max_round_seconds": float(rs.max()) if len(rs) else 0.0,
                "dropped_teams": int(np.sum(self.dropped_teams)),
                "dropped_devices": int(np.sum(self.dropped_devices))}
