"""The paper's published numbers — single source of truth.

Table 1 validation accuracies (%) from the PerMFL paper's A100 runs,
quoted next to our offline-synthetic reproductions for qualitative
side-by-side comparison (orderings, not magnitudes, are the reproduction
target). They ride on the scenario registry: each Table-1 scenario
carries its ``paper_ref`` pairs.

Keys are ``{algo}_{metric}`` in the paper's naming — note the paper
calls our ``l2gd`` baseline *AL2GD*, so lookups fall back to the
``a``-prefixed key.
"""
from __future__ import annotations

__all__ = ["PAPER_TABLE1_MCLR", "PAPER_TABLE1_NONCONVEX", "table1_ref"]

# {dataset: {algo_metric: paper accuracy %}}
PAPER_TABLE1_MCLR = {
    "mnist": {"fedavg_gm": 84.87, "perfedavg_pm": 94.81, "pfedme_pm": 88.89,
              "ditto_gm": 84.81, "hsgd_gm": 87.41, "al2gd_pm": 93.70,
              "permfl_gm": 86.92, "permfl_pm": 96.87},
    "synthetic": {"fedavg_gm": 79.80, "perfedavg_pm": 83.91,
                  "pfedme_pm": 87.61, "ditto_gm": 74.02, "hsgd_gm": 84.29,
                  "al2gd_pm": 84.75, "permfl_gm": 84.92, "permfl_pm": 87.94},
    "fmnist": {"fedavg_gm": 84.87, "perfedavg_pm": 94.75, "pfedme_pm": 91.23,
               "ditto_gm": 82.35, "hsgd_gm": 92.33, "al2gd_pm": 98.52,
               "permfl_gm": 83.71, "permfl_pm": 96.77},
    "emnist10": {"fedavg_gm": 91.60, "perfedavg_pm": 97.57,
                 "pfedme_pm": 91.32, "ditto_gm": 91.03, "hsgd_gm": 81.65,
                 "al2gd_pm": 98.72, "permfl_gm": 91.68, "permfl_pm": 96.49},
}
PAPER_TABLE1_NONCONVEX = {
    "mnist": {"fedavg_gm": 93.17, "perfedavg_pm": 91.85, "pfedme_pm": 97.40,
              "ditto_gm": 87.30, "hsgd_gm": 86.59, "al2gd_pm": 91.04,
              "permfl_gm": 89.39, "permfl_pm": 98.15},
    "synthetic": {"fedavg_gm": 84.53, "perfedavg_pm": 75.93,
                  "pfedme_pm": 87.86, "ditto_gm": 81.12, "hsgd_gm": 87.42,
                  "al2gd_pm": 84.92, "permfl_gm": 87.53, "permfl_pm": 87.89},
    "fmnist": {"fedavg_gm": 84.14, "perfedavg_pm": 88.69, "pfedme_pm": 96.30,
               "ditto_gm": 57.80, "hsgd_gm": 79.84, "al2gd_pm": 71.32,
               "permfl_gm": 79.15, "permfl_pm": 98.67},
    "emnist10": {"fedavg_gm": 92.73, "perfedavg_pm": 97.37,
                 "pfedme_pm": 97.18, "ditto_gm": 90.58, "hsgd_gm": 96.03,
                 "al2gd_pm": 92.94, "permfl_gm": 93.12, "permfl_pm": 98.79},
}


def table1_ref(dataset: str, convex: bool, key: str):
    """Paper accuracy for ``{algo}_{metric}`` ``key`` on ``dataset``
    (convex selects the MCLR vs non-convex table), or None if the paper
    does not quote that cell. ``l2gd_*`` falls back to the paper's
    ``al2gd_*`` naming."""
    table = PAPER_TABLE1_MCLR if convex else PAPER_TABLE1_NONCONVEX
    row = table.get(dataset, {})
    return row.get(key, row.get("a" + key))
