"""The wall-clock price of one global round, on the device.

The port's ``repro.system.simulate``: the engine calls
:func:`simulate_round` in every round of a run with a system model, at
the width of the masks (the cohort's under the cohort engine), before
the algorithm's round. The hierarchy's critical path prices a round as

    t_round =  max_i  [ wan_lat + full_bytes / wan_bw_i ]        broadcast
             + max_i  K * max_j [ compute_ij
                                  + 2 lan_lat
                                  + (full + comp bytes) / lan_bw_ij ]
             + max_i  [ wan_lat + comp_bytes / wan_bw_i ]        uplink

over participating teams i and devices j. With ``deadline_s > 0`` a
device whose own chain (its team's WAN down, its K LAN phases, its
team's WAN up) would end after the deadline leaves the round's masks,
and a team with no device left leaves with it; if nobody would make it,
the single fastest chain stays (``core.participation.keep_fastest``).

Everything is float32 tensor ops in the reference's order of operations.
The links are an operand (:func:`sample_links` draws them from a
``torch.Generator``), so a parity test can hand in the reference's
threefry draws. A scalar byte count divides as a float32 tensor, never
as ``int / tensor`` (which PyTorch computes as a reciprocal and a
product).
"""
from __future__ import annotations

import torch

from repro_torch.core.participation import keep_fastest
from repro_torch.system.spec import RoundWorkload

__all__ = ["sample_links", "simulate_round"]

_MBPS_TO_BPS = 125_000.0   # megabits/s -> bytes/s


def _f32(v, device) -> torch.Tensor:
    """A spec float (a Python float, a tensor, or a sweep's per-config
    values) as a float32 tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _lognormal(generator, mean, sigma, shape):
    # mean-preserving lognormal: E[mean * exp(sigma z - sigma^2/2)] = mean
    z = torch.randn(shape, generator=generator, device=generator.device)
    return mean * torch.exp(sigma * z - 0.5 * sigma * sigma)


def sample_links(leaves: dict, generator: torch.Generator, m: int, n: int):
    """One round's draws from a SystemSpec's distributions, on the
    generator's device, in the reference's order (rate, LAN, WAN).

    leaves: the spec's ``tree_floats()[0]``.
    Returns (rate (M, N) FLOP/s, lan_bps (M, N), wan_bps (M,)), float32.
    """
    f = {k: _f32(v, generator.device) for k, v in leaves.items()}
    rate = _lognormal(generator, f["compute_gflops"] * 1e9,
                      f["compute_sigma"], (m, n))
    lan = _lognormal(generator, f["lan_mbps"] * _MBPS_TO_BPS,
                     f["lan_sigma"], (m, n))
    wan = _lognormal(generator, f["wan_mbps"] * _MBPS_TO_BPS,
                     f["wan_sigma"], (m,))
    return rate, lan, wan


def simulate_round(leaves: dict, wl: RoundWorkload, links, team_mask,
                   device_mask):
    """Deadline-thinned masks and the round's critical-path time.

    leaves: the SystemSpec's float leaves: floats, or for a sweep each a
        (C,) set of per-config values.
    wl: the RoundWorkload (loop counts, wire bytes).
    links: (rate, lan_bps, wan_bps) shaped as the masks (see
        :func:`sample_links`; a sweep's stacked lead + (M, N) / lead +
        (M,)).
    team_mask lead + (M,) / device_mask lead + (M, N): the round's
        sampled participation in {0, 1}; lead is () or a sweep's (C,).

    Returns ``(team_mask', device_mask', t_round, dropped_teams,
    dropped_devices)``: the masks after deadline drops (device mask
    team-gated), the round's simulated seconds over the survivors and
    the int32 counts of deadline casualties, each shaped lead. With
    ``deadline_s == 0`` the masks pass through (team-gated).
    """
    dev = device_mask.device
    f = {k: _f32(v, dev) for k, v in leaves.items()}

    def at(name, nd):
        """Leaf ``name`` broadcast over ``nd`` trailing axes."""
        v = f[name]
        return v.reshape(tuple(v.shape) + (1,) * nd)

    rate, lan_bps, wan_bps = links
    lan_lat = at("lan_latency_ms", 2) * 1e-3
    wan_lat = at("wan_latency_ms", 1) * 1e-3
    work = (wl.local_steps * wl.n_params) * at("flops_per_param", 2)
    t_iter = (work / rate
              + 2.0 * lan_lat
              + _f32(wl.full_bytes + wl.comp_bytes, dev) / lan_bps)
    t_down = wan_lat + _f32(wl.full_bytes, dev) / wan_bps
    t_up = wan_lat + _f32(wl.comp_bytes, dev) / wan_bps
    chain = t_down[..., None] + wl.k_team * t_iter + t_up[..., None]

    gated = device_mask * team_mask[..., None]
    dl = at("deadline_s", 2)
    deadline = torch.where(dl > 0.0, dl, torch.full_like(dl, float("inf")))
    ok = (chain <= deadline).to(torch.float32)
    dm = gated * ok
    tm = team_mask * (dm.sum(dim=-1) > 0).to(torch.float32)
    tm, dm = keep_fastest(tm, dm, chain, gated)

    t_bcast = (t_down * tm).amax(dim=-1)
    t_lan = (wl.k_team * (t_iter * dm).amax(dim=-1) * tm).amax(dim=-1)
    t_round = t_bcast + t_lan + (t_up * tm).amax(dim=-1)

    dropped_t = (team_mask.sum(dim=-1) - tm.sum(dim=-1)).to(torch.int32)
    dropped_d = (gated.sum(dim=(-2, -1))
                 - dm.sum(dim=(-2, -1))).to(torch.int32)
    return tm, dm, t_round, dropped_t, dropped_d
