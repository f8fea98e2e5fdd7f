"""The roofline of a step on one H100 (the port of
``repro/roofline/analysis.py``).

Three terms, each the least time of one resource:

    compute    = each unit's operations over its peak, summed
                 (bf16 FLOPs / 989 TF/s + TF32 FLOPs / 495 TF/s
                  + f32 FLOPs / 67 TF/s + exponentials / the SFU rate)
    memory     = HBM bytes / 3.35 TB/s
    collective = collective bytes / NVLink's 450 GB/s (0 on one card)

The counts come from :func:`repro_torch.roofline.op_analysis.analyze_ops`
(the reference reads them off XLA's HLO). An eager step runs its ops one
after another on one stream, so each unit's time adds up; the step can
take no less than the larger of compute and memory. The reference's
``parse_collectives`` reads HLO text and has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import EXP_RATE, HBM_BW, NVLINK_BW
from repro_torch.roofline.kernels import RATES

__all__ = ["Roofline", "analyze", "model_flops_decode", "model_flops_train"]


@dataclass
class Roofline:
    """A step's counts, its three terms in seconds, the dominant one and
    the share of its FLOPs the model needs (``useful_ratio``)."""
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collectives: dict

    def summary(self) -> str:
        """One line: the three terms, the bound, the useful ratio."""
        return (f"compute={self.compute_s:.3e}s memory={self.memory_s:.3e}s "
                f"collective={self.collective_s:.3e}s -> {self.dominant}-bound"
                f" | useful={self.useful_ratio:.2f}")


def analyze(counts: dict, *, chips: int = 1, model_flops: float) -> Roofline:
    """The roofline of ``counts`` (an ``analyze_ops`` result, per device)
    on the H100's peaks; ``model_flops`` is global (6 N D), so the useful
    ratio compares model_flops / chips with the counted FLOPs."""
    flops = counts["flops"]
    hbm = counts["hbm_bytes"]
    coll = counts["collective_bytes"]
    units = counts["ops_by_unit"]
    compute_s = sum(units[u] / rate for u, rate in RATES.items()) \
        + units["exp"] / EXP_RATE
    memory_s = hbm / HBM_BW
    collective_s = coll / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / chips / flops) if flops else 0.0,
        collectives=dict(counts["collective_bytes_by_kind"]))


def model_flops_train(cfg, tokens: int) -> float:
    """6 * N_active * D (trained tokens)."""
    from repro_torch.configs.base import active_param_count
    return 6.0 * active_param_count(cfg) * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    """2 * N_active * D for forward-only decode."""
    from repro_torch.configs.base import active_param_count
    return 2.0 * active_param_count(cfg) * tokens
