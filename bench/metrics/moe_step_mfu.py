"""``moe_step_mfu``: the MoE decoder's FLOPs of the traced tier rounds (6
N_active D for the products with weights a token passes through, and
causal attention's, forward and backward, counted from its shapes by
``yardstick/moe.py``; l_local passes a round) over the host-clock
seconds of as many rounds run just before the traced ones without the
profiler, as a percent of the card's bfloat16 peak (its float32 one for
a float32 configuration). Capacity padding and the one-hot dispatch and
combine are not the model's FLOPs: a change that removes them raises
this share."""
from bench.yardstick.moe import moe_pass_flops
from bench.yardstick.peaks import PEAK_FLOPS


def read(t):
    cfg, mix = t.cell.config, t.cell.mix
    if t.steps == 0 or t.plain_s <= 0:
        return None
    rate = PEAK_FLOPS["bf16" if cfg["precision"] == "bfloat16" else "f32"]
    flops = moe_pass_flops(cfg["model"], mix["batch"], mix["seq_len"]) \
        * mix["tier"]["l_local"] * t.steps
    return 100.0 * flops / t.plain_s / rate
