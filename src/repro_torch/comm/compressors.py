"""Delta compressors for the tiered uplinks, over flat sender rows.

The reference's ``compress_tree`` / ``compress_tree_ef`` loop over a
tree's leaves and ``vmap`` a per-leaf compressor over the senders. The
port keeps a tier as one flat row per sender (``repro_torch.flat``), so
:func:`compress_flat` (no error feedback) and :func:`compress_flat_ef`
compress a whole (senders, S) buffer in ONE kernel launch: the leaves
are segments of the row, each compressed on its own -- its own k, int8
rows and sign scale -- exactly as the reference compresses each
(sender, leaf) pair. Without error feedback rand-k is unbiased (kept
values times p / k), as in the reference.

Static per-leaf facts (k, wire-buffer shapes) come from the cached
:func:`leaf_plan` / :func:`compression_plan`, as in the reference. The
uniforms of rand-k and int8 are drawn by the caller (one value per
column of the senders' rows, per uplink) and handed in, so a test can give
the port the reference's streams. Byte costs of the wire formats live in
``repro_torch.comm.ledger``.

The reference's ``REPRO_COMPRESS_FUSED=0`` legacy path has no
counterpart; no environment variable switches the port's main path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.comm.config import CommConfig
from repro_torch.flat import Layout
from repro_torch.kernels import compress as K
from repro_torch.kernels.quantize import quantize_int8
from repro_torch.kernels.segments import LANES

__all__ = ["LANES", "LeafPlan", "compress_flat", "compress_flat_ef",
           "compression_plan", "leaf_k", "leaf_plan", "needs_uniforms"]


def leaf_k(k_frac: float, p: int) -> int:
    """Coordinates kept per leaf by topk/randk."""
    return max(1, min(p, int(round(k_frac * p))))


@dataclass(frozen=True)
class LeafPlan:
    """Static per-(CommConfig, leaf) compression facts: the kept count
    ``k`` (top-k / rand-k), the 128-value row count, and the wire
    buffers each compressor ships (what the byte ledger prices)."""
    compressor: str
    p: int
    k: Optional[int]
    rows: int
    wire: tuple

    @staticmethod
    def build(cfg: CommConfig, p: int) -> "LeafPlan":
        """Derive the plan for one flat leaf of ``p`` coordinates."""
        rows = -(-p // LANES)
        name = cfg.compressor
        k = leaf_k(cfg.k_frac, p) if name in ("topk", "randk") else None
        wire = {
            "identity": (("values", (p,), "f32"),),
            "topk": (("values", (k,), "f32"), ("indices", (k,), "i32")),
            "randk": (("values", (k,), "f32"), ("seed", (), "u32")),
            "int8": (("q", (p,), "i8"), ("scales", (rows,), "f32")),
            "sign": (("bits", (rows, LANES // 8), "u8"), ("scale", (), "f32")),
        }[name]
        return LeafPlan(name, p, k, rows, wire)


@functools.lru_cache(maxsize=4096)
def leaf_plan(cfg: CommConfig, p: int) -> LeafPlan:
    """Cached :meth:`LeafPlan.build`."""
    return LeafPlan.build(cfg, p)


@functools.lru_cache(maxsize=1024)
def compression_plan(cfg: CommConfig, leaf_sizes: tuple) -> tuple:
    """Plans for a whole model (one entry per leaf), cached per
    (CommConfig, leaf sizes)."""
    return tuple(leaf_plan(cfg, p) for p in leaf_sizes)


def needs_uniforms(cfg: CommConfig) -> bool:
    """True when the compressor consumes one uniform per value (rand-k's
    scores, int8's rounding noise)."""
    return cfg.compressor in ("randk", "int8")


def _plan_segments(cfg: CommConfig, layout: Layout, b: int, u):
    """The segment table of ``layout`` for ``cfg`` (with top-k / rand-k's
    kept counts), after checking that a compressor which needs uniforms
    got them."""
    sizes = layout.leaf_sizes
    if needs_uniforms(cfg) and u is None:
        raise ValueError(f"{cfg.compressor} needs uniforms u of shape "
                         f"({b}, {layout.size})")
    if cfg.compressor in ("topk", "randk"):
        return K.segments(sizes, tuple(
            pl.k for pl in compression_plan(cfg, sizes)))
    return K.segments(sizes)


def compress_flat(cfg: CommConfig, layout: Layout, msg: torch.Tensor,
                  u: Optional[torch.Tensor] = None, *, mode=None):
    """Compress every sender row of ``msg`` without error feedback.

    msg: (B, S) float32 rows laid out by ``layout``; u: (B, >= P)
    uniforms, needed by rand-k and int8 (:func:`needs_uniforms`). mode:
    kernel mode (None: by device; "torch": the plain versions). Returns
    chat (B, S): what the receiver adds to the anchor it holds (zero
    past the P real columns). Identity sends ``msg`` itself; rand-k is
    unbiased.
    """
    name = cfg.compressor
    if name == "identity":
        return msg
    segs = _plan_segments(cfg, layout, msg.shape[0], u)
    if name == "topk":
        return K.topk(msg, segs, mode=mode)[0]
    if name == "randk":
        return K.randk(u, msg, segs, unbiased=True, mode=mode)[0]
    if name == "int8":
        return quantize_int8(msg, u, segs, mode=mode)[2]
    return K.sign(msg, segs, mode=mode)[2]


def compress_flat_ef(cfg: CommConfig, layout: Layout, delta: torch.Tensor,
                     ef: torch.Tensor, u: Optional[torch.Tensor] = None, *,
                     mode=None):
    """Compress every sender row of ``delta`` with its residual ``ef``
    (error feedback).

    delta, ef: (B, S) float32 rows laid out by ``layout``; u: (B, >= P)
    uniforms, needed by rand-k and int8 (:func:`needs_uniforms`). mode:
    kernel mode (None: by device; "torch": the plain versions).
    Returns (chat, ef_new), both (B, S): what the receiver adds to the
    anchor it holds, and the senders' new residuals. Identity sends
    ``delta + ef`` and leaves no residual.
    """
    name = cfg.compressor
    if name == "identity":
        return delta + ef, torch.zeros_like(ef)
    segs = _plan_segments(cfg, layout, delta.shape[0], u)
    if name == "topk":
        dq, _, ef_new = K.ef_topk(delta, ef, segs, mode=mode)
    elif name == "randk":
        dq, _, ef_new = K.ef_randk(u, delta, ef, segs, mode=mode)
    elif name == "int8":
        _, _, dq, ef_new = K.ef_int8(delta, ef, u, segs, mode=mode)
    else:
        _, _, dq, ef_new = K.ef_sign(delta, ef, segs, mode=mode)
    return dq, ef_new
