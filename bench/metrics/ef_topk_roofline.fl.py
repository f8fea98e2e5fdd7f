"""``ef_topk_roofline.fl``: the error-feedback top-k select's share of its
roofline (its count and scan kernels): K device uplinks (M * N senders)
and one team uplink (M senders) a round over the flat rows, each leaf its
own k; the frozen bound over the two kernels' device time, the calls
checked against the program's counter."""
from bench.reference.permfl_cnn import leaf_shapes
from bench.trace import roofline_share
from bench.yardstick.work import ef_topk

ROW_ALIGN = 64   # the flat rows' padding (columns a multiple of it)


def read(t):
    cfg = t.cell.config
    if t.cell.mix.get("uplink") is None:
        return None
    fed, k_team = cfg["federation"], cfg["algorithm"]["k_team"]
    leaves = len(leaf_shapes(cfg["model"]))
    p = cfg["parameters"]
    cols = -(-p // ROW_ALIGN) * ROW_ALIGN
    m, n = fed["m_teams"], fed["n_devices"]
    bound = k_team * ef_topk(m * n, cols, p, leaves).bound_s \
        + ef_topk(m, cols, p, leaves).bound_s
    return roofline_share(t, t.steps * bound, ("count_kernel<",
                                               "scan_kernel<"),
                          "ef_topk", t.steps * (k_team + 1))
