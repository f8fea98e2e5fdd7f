"""``attn_bwd_roofline.lm``: the attention backward (its D pre-pass, dq
and dk/dv kernels, ``flash_attention_bwd_hopper.cu``) as a percent of its
roofline: the frozen bound of a layer's call over the three kernels'
device time in the trace; one call a layer a pass, checked against the
program's counter."""
from bench.trace import roofline_share
from bench.yardstick.work import attention_bwd


def read(t):
    m, mix = t.cell.config["model"], t.cell.mix
    size = 2 if t.cell.config["precision"] == "bfloat16" else 4
    calls = t.steps * mix["tier"]["l_local"] * m["num_layers"]
    w = attention_bwd(mix["batch"], mix["seq_len"], mix["seq_len"],
                      m["num_heads"], m["num_kv_heads"], m["head_dim"],
                      causal=True, q_itemsize=size, kv_itemsize=size)
    return roofline_share(t, calls * w.bound_s,
                          ("delta_kernel", "dq_kernel", "dkv_kernel"),
                          "flash_attention_bwd", calls)
