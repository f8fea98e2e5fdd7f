"""``fl_round_mfu``: the paper model's FLOPs of the traced rounds (every
device step's forward and backward, and the evals' forwards, counted
from its shapes by ``yardstick/flops.py``) over the host-clock seconds
of as many rounds run just before the traced ones without the profiler,
as a percent of the card's float32 (CUDA-core) peak, or its TF32 peak
where the configuration lets TF32 run."""
from bench.yardstick.flops import permfl_round_flops
from bench.yardstick.peaks import PEAK_FLOPS


def read(t):
    cfg = t.cell.config
    if t.steps == 0 or t.plain_s <= 0:
        return None
    rate = PEAK_FLOPS["tf32" if cfg["tf32"] else "f32"]
    return 100.0 * permfl_round_flops(cfg) * t.steps / t.plain_s / rate
