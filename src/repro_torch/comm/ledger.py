"""Per-tier, per-round byte accounting for the PerMFL hierarchy (host only;
byte for byte the reference's ``repro/comm/ledger.py``).

Two links, four directions per global round t (DESIGN.md §3):

  WAN  server -> team   x broadcast, once per round, fp32
  WAN  team -> server   compressed w delta, once per round
  LAN  team -> device   w broadcast, once per team iteration (K per round),
                        fp32
  LAN  device -> team   compressed theta delta, once per team iteration

Only *participating* teams/devices move bytes, so ``log_round`` takes the
realized mask counts — and a device only transmits when its *team* also
participates (``ef_gate`` in ``permfl_round``), so device counts must be
computed from the gated mask ``device_mask * team_mask[:, None]`` (the
engine's counts are pre-gated).
Wire sizes are static functions of the compressor
config and the leaf shapes -- the ledger runs entirely on the host and
costs nothing on the device.

Wire-format byte model per leaf of p elements:

  identity  4p
  topk      8k            (4B value + 4B index, k = leaf_k(k_frac, p))
  randk     4k + 4        (shared seed reconstructs the indices)
  int8      p + 4*ceil(p/128)   (packed int8 + one f32 scale per 128-row)
  sign      ceil(p/8) + 4       (bit-packed signs + one f32 scale)
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.comm.compressors import leaf_k
from repro_torch.comm.config import CommConfig
from repro_torch.flat import Layout

__all__ = ["CommLedger", "RoundBytes", "compressed_leaf_bytes",
           "downlink_uplink_bytes", "full_leaf_bytes", "model_bytes"]


def full_leaf_bytes(p: int) -> int:
    """Wire bytes of one fp32 leaf of p elements."""
    return 4 * p


def compressed_leaf_bytes(cfg: CommConfig, p: int) -> int:
    """Wire bytes of one compressed leaf of p elements (see the wire-format
    byte model in the module docstring)."""
    name = cfg.compressor
    if name == "identity":
        return 4 * p
    if name == "topk":
        return 8 * leaf_k(cfg.k_frac, p)
    if name == "randk":
        return 4 * leaf_k(cfg.k_frac, p) + 4
    if name == "int8":
        return p + 4 * math.ceil(p / 128)
    if name == "sign":
        return math.ceil(p / 8) + 4
    raise ValueError(name)


def model_bytes(leaf_sizes, cfg: Optional[CommConfig] = None) -> int:
    """Wire size of one model/delta; cfg=None means full fp32."""
    if cfg is None:
        return sum(full_leaf_bytes(p) for p in leaf_sizes)
    return sum(compressed_leaf_bytes(cfg, p) for p in leaf_sizes)


def downlink_uplink_bytes(leaf_sizes, cfg: Optional[CommConfig] = None):
    """(downlink, uplink) wire bytes of one model or delta: downlinks
    always carry fp32 anchors, uplinks the compressed delta (cfg=None:
    uncompressed both ways). The pair the system simulator
    (``repro_torch.system``) prices the links with."""
    return model_bytes(leaf_sizes), model_bytes(leaf_sizes, cfg)


@dataclass
class RoundBytes:
    """One global round's traffic, bytes per link-direction."""
    wan_up: int = 0
    wan_down: int = 0
    lan_up: int = 0
    lan_down: int = 0

    @property
    def total(self) -> int:
        return self.wan_up + self.wan_down + self.lan_up + self.lan_down


@dataclass
class CommLedger:
    """Accumulates RoundBytes; built by run_permfl when comm is enabled."""
    cfg: CommConfig
    leaf_sizes: tuple
    rounds: list = field(default_factory=list)

    @classmethod
    def for_layout(cls, cfg: CommConfig, layout: Layout) -> "CommLedger":
        """Ledger sized from a flat layout's leaf sizes."""
        return cls(cfg=cfg, leaf_sizes=layout.leaf_sizes)

    @classmethod
    def for_params(cls, cfg: CommConfig, params) -> "CommLedger":
        """Ledger sized from an (unstacked) model tree's leaf shapes."""
        return cls.for_layout(cfg, Layout.of(params))

    def log_round(self, *, k_team: int, n_teams: int, n_devices: int):
        """n_teams / n_devices: participating counts this round; n_devices
        must already be gated by team participation (see module
        docstring)."""
        full = model_bytes(self.leaf_sizes)
        comp = model_bytes(self.leaf_sizes, self.cfg)
        self.rounds.append(RoundBytes(
            wan_up=n_teams * comp,
            wan_down=n_teams * full,
            lan_up=k_team * n_devices * comp,
            lan_down=k_team * n_devices * full))

    def log_round_masks(self, *, k_team: int, team_mask, device_mask):
        """:meth:`log_round` from raw participation masks (team (M,),
        device (M, N); tensors or arrays): devices of masked-out teams
        never transmit (nor receive), whatever ``device_mask`` says."""
        tm = torch.as_tensor(team_mask, dtype=torch.float64).cpu()
        gated = torch.as_tensor(device_mask,
                                dtype=torch.float64).cpu() * tm[:, None]
        self.log_round(k_team=k_team, n_teams=int(tm.sum()),
                       n_devices=int(gated.sum()))

    # -- aggregates ---------------------------------------------------------

    def totals(self) -> RoundBytes:
        """Sum of all logged rounds, per link-direction."""
        out = RoundBytes()
        for r in self.rounds:
            out.wan_up += r.wan_up
            out.wan_down += r.wan_down
            out.lan_up += r.lan_up
            out.lan_down += r.lan_down
        return out

    def total_bytes(self) -> int:
        """Grand total across links, directions, and rounds."""
        return self.totals().total

    def cum_total_bytes(self) -> list:
        """Cumulative grand total after each logged round: the byte axis
        the event log (``repro_torch.obs.events``) joins against the
        metric history at the eval points."""
        return list(itertools.accumulate(r.total for r in self.rounds))

    def uncompressed_total(self) -> int:
        """What the same rounds would have cost shipping fp32 everywhere."""
        full = model_bytes(self.leaf_sizes)
        comp = model_bytes(self.leaf_sizes, self.cfg)
        t = self.totals()
        up_models = (t.wan_up + t.lan_up) // comp if comp else 0
        return t.wan_down + t.lan_down + up_models * full

    def summary(self) -> dict:
        """Flat dict of per-direction totals, compressed-vs-fp32 totals,
        and the uplink compression ratio — benchmark CSV material."""
        t = self.totals()
        return {"compressor": self.cfg.compressor,
                "rounds": len(self.rounds),
                "wan_up_bytes": t.wan_up, "wan_down_bytes": t.wan_down,
                "lan_up_bytes": t.lan_up, "lan_down_bytes": t.lan_down,
                "total_bytes": t.total,
                "uncompressed_bytes": self.uncompressed_total(),
                "uplink_ratio": (model_bytes(self.leaf_sizes)
                                 / max(model_bytes(self.leaf_sizes, self.cfg),
                                       1))}
