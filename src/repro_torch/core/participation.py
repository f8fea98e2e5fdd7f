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

The cohort engine (``repro_torch.train.engine``, ``cohort=``) samples a
per-team index map of the devices it materializes each round
(:func:`sample_cohort`), and the system simulator (``repro_torch.system``)
thins the masks by a deadline, falling back to the fastest participant
when nobody would make it (:func:`keep_fastest`).
"""
from __future__ import annotations

import torch

__all__ = ["MODES", "keep_fastest", "sample_cohort", "sample_masks"]

# the paper's four participation modes (§3.1) as sample_masks fractions
MODES = {
    "full": dict(team_frac=1.0, device_frac=1.0),
    "partial_devices": dict(team_frac=1.0, device_frac=0.5),
    "partial_teams": dict(team_frac=0.5, device_frac=1.0),
    "partial_both": dict(team_frac=0.5, device_frac=0.5),
}


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


def sample_cohort(generator: torch.Generator, m_teams: int, n_devices: int,
                  cohort_size: int) -> torch.Tensor:
    """Per-team cohort indices for the cohort engine: an (M, cohort_size)
    int64 index map on the generator's device, each row a sorted sample
    of ``cohort_size`` distinct devices out of ``n_devices``.

    The top-``cohort_size`` of N uniforms per team, sorted, as the
    reference's ``lax.top_k`` over threefry uniforms (its draws cannot be
    reproduced here; parity runs inject its maps). Sorting makes the map
    canonical, so ``cohort_size == n_devices`` gives ``arange(n)`` in
    every row: an identity gather, which keeps the full-width cohort run
    bit-equal to the stacked one. One uniform draw and a top-k stay
    cheap at N = 10^6, where a permutation would not.
    """
    z = torch.rand((m_teams, n_devices), generator=generator,
                   device=generator.device)
    idx = torch.topk(z, cohort_size, dim=-1, sorted=False).indices
    return idx.sort(dim=-1).values


def keep_fastest(team_mask, device_mask, score, candidates):
    """A non-empty round after mask thinning (deadline drops): if the
    team-gated ``device_mask`` kept nobody, keep only the single (team,
    device) pair with the least ``score`` among ``candidates``; the
    first such pair in row order on ties (``torch.argmin``, as
    ``jnp.argmin``).

    team_mask lead + (M,) / device_mask lead + (M, N): the thinned masks
    (lead: () or a sweep's (C,), each config decided on its own).
    score lead + (M, N): per-device priority (lower wins), e.g. chain
    times; candidates lead + (M, N): {0, 1} mask of the eligible pairs.
    Returns (team_mask, device_mask) with device_mask team-gated.
    """
    gated = device_mask * team_mask[..., None]
    alive = gated.sum(dim=(-2, -1)) > 0
    masked = torch.where(candidates > 0, score,
                         torch.full_like(score, float("inf")))
    flat = masked.flatten(-2)
    one = torch.zeros_like(flat).scatter_(
        -1, flat.argmin(dim=-1, keepdim=True), 1.0).view(masked.shape)
    fb_tm = one.sum(dim=-1).clamp(0.0, 1.0)
    return (torch.where(alive[..., None], team_mask, fb_tm),
            torch.where(alive[..., None, None], gated, one))
