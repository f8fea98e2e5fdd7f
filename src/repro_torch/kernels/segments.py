"""The segment table of flat sender rows, shared by the compress and
quantize kernels, and the checks their wrappers make before a launch.

A tier is one flat row per sender with the parameter leaves packed back
to back (``repro_torch.flat``). A :class:`Segments` table says where each
leaf lies in the row, so ONE kernel launch covers every (sender, leaf)
pair while each leaf is still compressed on its own: its own k, its own
128-value wire rows counted from the leaf's first value (the last one
zero-padded), its own sign scale.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

__all__ = ["LANES", "Segments", "check_rows", "given", "leaf_columns",
           "raise_on", "segments", "senders_ok", "stream"]

# values per int8 scale / sign row
LANES = 128


@dataclass(frozen=True)
class Segments:
    """Where each leaf lies in a flat sender row.

    offsets / lengths: each leaf's first column and size p (>= 1), in
    row order, back to back from column 0; ks: the values top-k / rand-k
    keep of each leaf (0 where unused); row0: each leaf's first 128-value
    wire row among all leaves' rows.
    """
    offsets: tuple
    lengths: tuple
    ks: tuple
    row0: tuple

    @property
    def end(self) -> int:
        """One past the last leaf's last column."""
        return self.offsets[-1] + self.lengths[-1]

    @property
    def rows(self) -> int:
        """The 128-value wire rows of all leaves together."""
        return self.row0[-1] + -(-self.lengths[-1] // LANES)

    def table(self, device) -> torch.Tensor:
        """The kernels' (leaves, 4) int64 table on ``device``: offset,
        length, k, first wire row."""
        return _table(self, str(torch.device(device)))


@functools.lru_cache(maxsize=1024)
def segments(lengths: tuple, ks: tuple = None) -> Segments:
    """The (cached) :class:`Segments` of leaves of ``lengths`` packed
    back to back; ``ks`` the kept counts for top-k / rand-k."""
    lengths = tuple(int(n) for n in lengths)
    if not lengths or min(lengths) < 1:
        raise ValueError(f"every leaf needs at least one value: {lengths}")
    ks = (0,) * len(lengths) if ks is None else tuple(int(k) for k in ks)
    if len(ks) != len(lengths) or any(
            not 0 <= k <= n for k, n in zip(ks, lengths)):
        raise ValueError(f"bad k per leaf {ks} for leaves {lengths}")
    offsets, row0 = [0], [0]
    for n in lengths[:-1]:
        offsets.append(offsets[-1] + n)
        row0.append(row0[-1] + -(-n // LANES))
    return Segments(tuple(offsets), lengths, ks, tuple(row0))


@functools.lru_cache(maxsize=256)
def _table(segs: Segments, device: str) -> torch.Tensor:
    rows = list(zip(segs.offsets, segs.lengths, segs.ks, segs.row0))
    return torch.tensor(rows, dtype=torch.int64, device=device)


def leaf_columns(segs: Segments):
    """(leaf index, column slice, k) per leaf."""
    return [(i, slice(o, o + n), k) for i, (o, n, k) in
            enumerate(zip(segs.offsets, segs.lengths, segs.ks))]


def check_rows(segs: Segments, **rows):
    """Every operand a float32 (senders, columns) tensor with unit column
    stride, at least ``segs.end`` columns, the same senders and one
    device; None operands are skipped."""
    b = None
    devs = set()
    for name, t in rows.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be (senders, columns), got "
                             f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} needs unit-stride columns")
        if t.shape[1] < segs.end:
            raise ValueError(f"{name} has {t.shape[1]} columns, the leaves "
                             f"need {segs.end}")
        if b is not None and t.shape[0] != b:
            raise ValueError(f"{name} has {t.shape[0]} senders, not {b}")
        b = t.shape[0]
        devs.add(t.device)
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def given(t, b, segs: Segments, what):
    """A caller's (B, leaves) per-(sender, leaf) value, checked."""
    if t.shape != (b, len(segs.lengths)) or t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32 (senders, leaves) = "
                         f"{(b, len(segs.lengths))}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def stream(t):
    """The current CUDA stream of ``t``'s device, as a Python int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err, name, t):
    """Raise if a launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(senders={t.shape[0]}, columns={t.shape[1]})")


def senders_ok(t):
    """False for no senders (nothing to launch); raises beyond the
    kernels' grid limit."""
    if t.shape[0] > 65535:
        raise ValueError(f"the compress kernels take at most 65535 "
                         f"senders, got {t.shape[0]}")
    return t.shape[0] > 0
