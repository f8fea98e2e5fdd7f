"""Team formation strategies for the §4.1.4 ablation.

The paper: teams are static; PerMFL accommodates any formation mechanism.
  * worst    — teams own disjoint label groups (team 1: {0..4}, team 2:
               {5..9}) — maximal inter-team heterogeneity.
  * average  — overlapping label groups (team 1: {0..6}, team 2:
               {5..9,0,1}).
  * random   — devices shuffled into teams regardless of labels (the
               default of §4's main experiments).

These return, for each team, the *label pool* its devices draw from;
repro_torch.data.federated partitions samples accordingly.
"""
from __future__ import annotations

import numpy as np


def label_pools(strategy: str, m_teams: int, num_classes: int,
                overlap: int = 2):
    if strategy == "worst":
        per = num_classes // m_teams
        return [list(range(i * per, (i + 1) * per)) +
                (list(range(m_teams * per, num_classes)) if i == m_teams - 1
                 else [])
                for i in range(m_teams)]
    if strategy == "average":
        per = num_classes // m_teams
        pools = []
        for i in range(m_teams):
            base = [(i * per + j) % num_classes for j in range(per + overlap)]
            pools.append(sorted(set(base)))
        return pools
    if strategy == "random":
        return [list(range(num_classes)) for _ in range(m_teams)]
    raise ValueError(strategy)


def assign_devices(rng: np.random.Generator, m_teams: int, n_devices: int):
    """Random grouping of M*N device ids into M teams (paper §4: 'devices
    were randomly grouped into four teams')."""
    ids = rng.permutation(m_teams * n_devices)
    return ids.reshape(m_teams, n_devices)
