"""The comparisons that decide ``correct``: a compared number is a gap
between what the program produced and what the plain reference works
out, held against a limit of its own."""
from __future__ import annotations

import math
import statistics


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want| (inf where got is not finite)."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / abs(want)


def worst_rel(got, want) -> float:
    """The largest :func:`rel_gap` of paired sequences."""
    return max(rel_gap(g, w) for g, w in zip(got, want, strict=True))


def norm_gap(got: dict, want: dict, groups: dict = None,
             keep=None) -> tuple:
    """The worst leaf's gap between the program's and the reference's
    norms: |got - want| over the larger of the reference's norm of that
    leaf and the median leaf's norm of its group (``groups``: leaf ->
    group; one group by default). ``keep``: the leaves compared (all by
    default). Returns (gap, leaf)."""
    groups = groups or {k: "" for k in want}
    by = {}
    for k, v in want.items():
        by.setdefault(groups[k], []).append(v)
    med = {g: statistics.median(v) for g, v in by.items()}
    worst = (0.0, None)
    for k, w in want.items():
        if keep is not None and k not in keep:
            continue
        g = got.get(k, 0.0)
        gap = math.inf if not math.isfinite(g) else \
            abs(g - w) / max(w, med[groups[k]], 1e-30)
        if gap > worst[0] or worst[1] is None:
            worst = (gap, k)
    return worst


def median_gap(got: dict, want: dict) -> float:
    """The median leaf's gap of :func:`norm_gap`'s kind: steady where one
    leaf's gap swings from seed to seed (a ReLU or a max-pool that
    switches on rounding moves one unit's leaves alone)."""
    med = statistics.median(want.values())
    gaps = [math.inf if not math.isfinite(got.get(k, 0.0)) else
            abs(got.get(k, 0.0) - w) / max(w, med, 1e-30)
            for k, w in want.items()]
    return statistics.median(gaps)


def moved_leaves(grad_norms: dict) -> set:
    """Leaves whose first gradient in the reference is more than a
    thousandth of the median leaf's: the others move under the
    optimizer by rounding alone and are left out of the change."""
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v > 1e-3 * med}


def check(name: str, value: float, limit: float, **detail) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit),
            **detail}
