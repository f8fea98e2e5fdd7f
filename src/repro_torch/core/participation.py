"""Team/device participation sampling -- the paper's four modes (§3.1):

  1. full teams, full devices
  2. full teams, partial devices
  3. partial teams, full devices
  4. partial teams, partial devices

Masks are sampled per global round from an explicit ``torch.Generator``
(the port cannot reproduce the reference's threefry stream, so parity
runs inject the reference's masks instead, see
``repro_torch.train.engine.run_experiment``). At least one team, and the
same number of devices in every team, is always kept.
"""
from __future__ import annotations

import torch

__all__ = ["sample_masks"]


def sample_masks(generator: torch.Generator, m_teams: int, n_devices: int,
                 *, team_frac: float = 1.0, device_frac: float = 1.0):
    """Returns (team_mask (M,), device_mask (M, N)) float32 in {0, 1} on
    the generator's device; device_mask is gated by team_mask."""
    dev = generator.device
    n_t = max(1, round(m_teams * team_frac))
    n_d = max(1, round(n_devices * device_frac))
    team_mask = torch.zeros(m_teams, device=dev)
    team_mask[torch.randperm(m_teams, generator=generator,
                             device=dev)[:n_t]] = 1.0
    device_mask = torch.zeros(m_teams, n_devices, device=dev)
    for i in range(m_teams):
        perm = torch.randperm(n_devices, generator=generator, device=dev)
        device_mask[i, perm[:n_d]] = 1.0
    return team_mask, device_mask * team_mask[:, None]
