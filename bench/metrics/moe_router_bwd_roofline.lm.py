"""``moe_router_bwd_roofline.lm``: the fused router backward (dl, dx and
dw in one kernel, ``router_bwd_fused`` in ``moe_router_bwd_hopper.cu``)
as a percent of its roofline: the frozen bound (``yardstick/moe.py``) of
a MoE layer's call over the kernel's device time in the trace; one call
a MoE layer a backward pass, checked against the program's counter."""
from bench.trace import roofline_share
from bench.yardstick.moe import moe_router_bwd


def read(t):
    m, mix = t.cell.config["model"], t.cell.mix
    size = 2 if t.cell.config["precision"] == "bfloat16" else 4
    calls = t.steps * mix["tier"]["l_local"] \
        * (m["num_layers"] - m["first_dense_layers"])
    mo = m["moe"]
    w = moe_router_bwd(mix["batch"] * mix["seq_len"], m["d_model"],
                       mo["num_experts"], mo["top_k"], x_itemsize=size)
    return roofline_share(t, calls * w.bound_s, ("router_bwd_fused<",),
                          "moe_router_bwd", calls)
