"""``attn_fwd_roofline.lm``: the training forward's attention kernel
(``attn_wgmma_kernel``, with the log-sum-exp a gradient needs) as a
percent of its roofline: the frozen bound (``yardstick/work.py``) of a
layer's call over the kernel's mean device time in the trace; one call
a layer a pass, checked against the program's counter."""
from bench.trace import roofline_share
from bench.yardstick.work import attention


def read(t):
    m, mix = t.cell.config["model"], t.cell.mix
    size = 2 if t.cell.config["precision"] == "bfloat16" else 4
    calls = t.steps * mix["tier"]["l_local"] * m["num_layers"]
    w = attention(mix["batch"], mix["seq_len"], mix["seq_len"],
                  m["num_heads"], m["num_kv_heads"], m["head_dim"],
                  causal=True, q_itemsize=size, kv_itemsize=size, lse=True)
    return roofline_share(t, calls * w.bound_s, ("attn_wgmma_kernel<",),
                          "flash_attention", calls)
