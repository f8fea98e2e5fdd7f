"""Communication config and per-tier error-feedback state.

``CommConfig`` is a frozen (hashable) dataclass, field for field the
reference's, so a scenario that names one hashes alike in both packages.
``CommState`` holds the error-feedback residuals as flat tier buffers
laid out like the models (``repro_torch.flat``): one row per device for
the device->team LAN uplink, ef_dev (M, N, S), and one per team for the
team->server WAN uplink, ef_team (M, S); plus the ``torch.Generator``
the stochastic compressors (rand-k, int8) draw their uniforms from.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.flat import Layout, tree_leaves

__all__ = ["COMPRESSORS", "CommConfig", "CommState", "copy_generator",
           "init_comm_state"]

COMPRESSORS = ("identity", "topk", "randk", "int8", "sign")


@dataclass(frozen=True)
class CommConfig:
    """What crosses the links, and how it is shrunk.

    compressor: one of COMPRESSORS, applied to the model *deltas* on the
        two uplinks (device->team theta deltas inside the K-loop,
        team->server w deltas once per round). Downlinks stay float32.
    k_frac: fraction of coordinates kept per leaf by topk / randk.
    error_feedback: accumulate the compression residual into the
        sender's buffer and add it to the next message (EF-SGD style);
        rand-k is then left unscaled (contractive form).
    seed: seed of the generator the stochastic compressors draw from.
    """
    compressor: str = "identity"
    k_frac: float = 0.1
    error_feedback: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.compressor not in COMPRESSORS:
            raise ValueError(
                f"unknown compressor {self.compressor!r}; "
                f"expected one of {COMPRESSORS}")
        if not 0.0 < self.k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {self.k_frac}")

    @property
    def lossy(self) -> bool:
        """True for every compressor but identity."""
        return self.compressor != "identity"


@dataclass
class CommState:
    """ef_dev (M, N, S): device-uplink residuals; ef_team (M, S):
    team-uplink residuals; gen: the generator of the rand-k / int8
    uniforms, on the residuals' device. A round never advances ``gen``
    in place: it draws from a copy, which the new state carries. A
    sweep's stacked state holds ef_dev (C, M, N, S), ef_team (C, M, S)
    and a tuple of C generators, one per config."""
    ef_dev: torch.Tensor
    ef_team: torch.Tensor
    gen: object             # torch.Generator, or a tuple of them

    def generator_copy(self):
        """A new generator in the same state as ``gen`` (a tuple of copies
        for a tuple)."""
        if isinstance(self.gen, tuple):
            return tuple(copy_generator(g) for g in self.gen)
        return copy_generator(self.gen)


def copy_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device, in the same state."""
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def init_comm_state(params, m_teams: int, n_devices: int,
                    cfg: CommConfig) -> CommState:
    """Zero residuals shaped like the stacked tiers of ``params`` (one
    unstacked model) and a generator seeded with ``cfg.seed``, on the
    device of the model's leaves."""
    layout = Layout.of(params)
    dev = tree_leaves(params)[0][1].device
    return CommState(
        ef_dev=torch.zeros((m_teams, n_devices, layout.stride),
                           dtype=torch.float32, device=dev),
        ef_team=torch.zeros((m_teams, layout.stride), dtype=torch.float32,
                            device=dev),
        gen=torch.Generator(device=dev).manual_seed(cfg.seed))

