"""``prox_update_roofline.lm``: the device step kernel's share of its
roofline in a tier round (``prox_sgd_tree``: one launch a leaf, l_local
times a round): the frozen bound of every leaf's step (theta, grad and
anchor read and theta' written in the stored type) over the kernels'
device time in the trace, the launches checked against the program's
counter."""
from bench.reference.phi3 import leaf_shapes
from bench.trace import roofline_share
from bench.yardstick.work import prox_update


def read(t):
    cfg, mix = t.cell.config, t.cell.mix
    size = 2 if cfg["precision"] == "bfloat16" else 4
    shapes = leaf_shapes(cfg["model"])
    calls = t.steps * mix["tier"]["l_local"]
    bound = 0.0
    for shape in shapes.values():
        cols = shape[-1]
        rows = 1
        for s in shape[:-1]:
            rows *= s
        bound += prox_update(rows, cols, itemsize=size,
                             anchor_rows=rows).bound_s
    return roofline_share(t, calls * bound, ("prox_kernel<",),
                          "prox_update", calls * len(shapes))
