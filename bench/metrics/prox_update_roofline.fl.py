"""``prox_update_roofline.fl``: the device step kernel's share of its
roofline in a PerMFL round: K * L launches a round over every device's
flat row (float32), the frozen bound (``yardstick/work.py``) over the
kernels' device time in the trace, its launches checked against the
program's counter."""
from bench.trace import roofline_share
from bench.yardstick.work import prox_update


def read(t):
    cfg = t.cell.config
    fed, algo = cfg["federation"], cfg["algorithm"]
    calls = t.steps * algo["k_team"] * algo["l_local"]
    w = prox_update(fed["m_teams"] * fed["n_devices"], cfg["parameters"],
                    itemsize=4, anchor_rows=fed["m_teams"])
    return roofline_share(t, calls * w.bound_s, ("prox_kernel<",),
                          "prox_update", calls)
