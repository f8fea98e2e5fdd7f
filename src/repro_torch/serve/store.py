"""(team, device)-keyed model store for personalized serving.

Training ends with every device owning its own model (PerMFL's theta).
A :class:`ModelStore` is exported from a trained state through the
``FLAlgorithm.serving_params`` hook and holds three tiers, each as flat
parameter rows laid out by the state's :class:`repro_torch.flat.Layout`:

* **global** -- one row (S,), the last-resort fallback;
* **team** -- (M, S) team anchors;
* **device** -- (M, N, S) personal models, stored against the owning
  team's anchor so the per-device cost is the residual.

Encodings of the device tier, those of the reference
(``repro/serve/store.py``): ``"delta"`` (default) stores the *bit-pattern*
difference -- the float rows viewed as same-width integers and
subtracted with wrapping arithmetic -- so decode is exactly invertible
and a served device is bit-identical to its trained row; ``"int8"``
feeds the float residual through the int8 quantize kernel
(``repro_torch.kernels.quantize``, noise 0.5: round to nearest; one
launch over all M*N devices, each leaf over its own 128-value rows) for
~3.9x smaller device tiers at bounded error; ``"raw"`` keeps full
per-device copies.

Lookup resolves down the tier ladder with no Python loop over requests:
a request tagged with an unknown device falls back to its team anchor,
an unknown team to the global model -- out-of-range indices are clipped
for the gather and masked out with ``torch.where``, never an error,
because serving traffic is where stale IDs show up. A host-side LRU
keeps hot principals' decoded rows out of the decode path. Persistence
writes the reference's checkpoint (``repro_torch.train.checkpoint``)
with the reference's key paths (``global/...``, ``team/...``,
``device/...[/q|/scales]``), so each package loads the other's stores.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.flat import Layout
from repro_torch.kernels.quantize import dequantize_int8, quantize_int8
from repro_torch.kernels.segments import LANES, segments
from repro_torch.obs.spans import span
from repro_torch.train.checkpoint import (load_checkpoint_arrays,
                                          save_checkpoint)

__all__ = ["ENCODINGS", "ModelStore"]

ENCODINGS = ("delta", "int8", "raw")

# float dtype -> the same-width integer dtype of its bit patterns
_INT_TWIN = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16, torch.float64: torch.int64}


def _check_encoding(encoding):
    if encoding not in ENCODINGS:
        raise ValueError(
            f"unknown encoding {encoding!r}; want one of {ENCODINGS}")


def _encode(dev_rows, team_rows, encoding, layout, mode):
    """dev_rows (M, N, S), team_rows (M, S) -> the device payload."""
    if encoding == "raw":
        return dev_rows
    anchor = team_rows[:, None].expand_as(dev_rows)
    if encoding == "delta":
        it = _INT_TWIN[dev_rows.dtype]
        return dev_rows.view(it) - anchor.view(it)
    if dev_rows.dtype != torch.float32:
        raise ValueError(f"int8 encoding needs float32 rows, got "
                         f"{dev_rows.dtype}")
    m, n, s = dev_rows.shape
    resid = (dev_rows - anchor).reshape(m * n, s)
    # noise 0.5 = round to nearest: the store is an export artifact, not
    # an unbiased-in-expectation uplink
    noise = torch.full((1, s), 0.5, device=resid.device).expand(m * n, s)
    q, scales, _ = quantize_int8(resid, noise, segments(layout.leaf_sizes),
                                 mode=mode)
    return {"q": q.view(m, n, s), "scales": scales.view(m, n, -1)}


class ModelStore:
    """Three-tier (global / team / device) parameter store with tier
    fallback, exported from a trained algorithm state and served batched
    (see ``repro_torch.serve.personalized``).

    global_row (S,), team_rows (M, S): float rows laid out by ``layout``;
    payload: the encoded device tier -- (M, N, S) integer bit-pattern
    differences for ``"delta"``, (M, N, S) rows for ``"raw"``, and
    ``{"q": (M, N, S) int8, "scales": (M, N, rows)}`` for ``"int8"``.
    """

    def __init__(self, layout: Layout, global_row, team_rows, payload, *,
                 encoding: str, m: int, n: int, cache_size: int = 64):
        """Normally built via :meth:`from_state` / :meth:`load`."""
        _check_encoding(encoding)
        self.layout = layout
        self.global_row = global_row
        self.team_rows = team_rows
        self.payload = payload
        self.encoding = encoding
        self.m = int(m)
        self.n = int(n)
        self.cache_size = int(cache_size)
        self._cache: OrderedDict = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    @property
    def device(self) -> torch.device:
        """Where the tiers live."""
        return self.global_row.device

    @classmethod
    def from_state(cls, algo, state, *, m: int, n: int,
                   encoding: str = "delta", cache_size: int = 64,
                   mode=None):
        """Export a trained algorithm ``state`` into a store: the tiers
        are gathered through ``algo.serving_params`` with index tensors
        (one gather per tier, no per-device Python), then the device
        tier is encoded against its team anchors (``mode``: the
        quantize kernel's mode for ``"int8"``)."""
        _check_encoding(encoding)
        with span("store_export", encoding=encoding, m=m, n=n):
            dev = state.x.device
            ts = torch.arange(m, device=dev)
            ds = torch.arange(n, device=dev)
            g = algo.serving_params(state).clone()
            team = algo.serving_params(state, ts)
            rows = algo.serving_params(state, ts[:, None], ds[None, :])
            payload = _encode(rows, team, encoding, state.layout, mode)
            return cls(state.layout, g, team, payload, encoding=encoding,
                       m=m, n=n, cache_size=cache_size)

    @classmethod
    def from_result(cls, algo, result, *, m: int, n: int,
                    encoding: str = "delta", cache_size: int = 64):
        """:meth:`from_state` on a finished ``FLResult.state``."""
        return cls.from_state(algo, result.state, m=m, n=n,
                              encoding=encoding, cache_size=cache_size)

    # ---------------------------------------------------------- lookup

    def _decode(self, t, d, team_rows):
        """Decoded device rows for in-range index tensors ``t`` / ``d``,
        given the matching team anchors."""
        if self.encoding == "raw":
            return self.payload[t, d]
        if self.encoding == "delta":
            it = _INT_TWIN[team_rows.dtype]
            return (team_rows.view(it) + self.payload[t, d]) \
                .view(team_rows.dtype)
        dq = dequantize_int8(self.payload["q"][t, d],
                             self.payload["scales"][t, d],
                             segments(self.layout.leaf_sizes))
        return team_rows + dq

    def _masks(self, team, device):
        team = torch.as_tensor(team, dtype=torch.int64, device=self.device)
        device = torch.as_tensor(device, dtype=torch.int64,
                                 device=self.device)
        ok_t = (team >= 0) & (team < self.m)
        ok_d = ok_t & (device >= 0) & (device < self.n)
        return team, device, ok_t, ok_d

    def gather(self, team, device) -> torch.Tensor:
        """Batched tier-resolved lookup: (B,) integer team / device tags
        in, (B, S) parameter rows out.

        Per request: in-range (team, device) -> the decoded personal
        row; in-range team with an unknown device -> the team anchor;
        unknown team -> the global row. Out-of-range indices are clipped
        for the gather and masked out of the result."""
        team, device, ok_t, ok_d = self._masks(team, device)
        t = team.clamp(0, self.m - 1)
        d = device.clamp(0, self.n - 1)
        team_rows = self.team_rows[t]
        dev_rows = self._decode(t, d, team_rows)
        return torch.where(ok_d[:, None], dev_rows,
                           torch.where(ok_t[:, None], team_rows,
                                       self.global_row))

    def resolve_tiers(self, team, device) -> dict:
        """``{"device", "team", "global"}`` 0-d integer tensors: how many
        requests of the batch resolve at each tier under the masks of
        :meth:`gather`; they sum to the batch size."""
        _, _, ok_t, ok_d = self._masks(team, device)
        return {"device": ok_d.sum(), "team": (ok_t & ~ok_d).sum(),
                "global": (~ok_t).sum()}

    def cache_stats(self) -> dict:
        """Host-side LRU telemetry: ``{hits, misses, hit_rate, size}``;
        ``hit_rate`` is hits / (hits + misses), 0.0 before any lookup."""
        total = self.cache_hits + self.cache_misses
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "hit_rate": self.cache_hits / total if total else 0.0,
                "size": len(self._cache)}

    def reset_cache_stats(self) -> None:
        """Zero the hit/miss counters (cached entries stay)."""
        self.cache_hits = 0
        self.cache_misses = 0

    def params_for(self, team=None, device=None) -> torch.Tensor:
        """Single-principal lookup with the host-side LRU in front:
        ``params_for()`` the global row, ``params_for(t)`` the team
        anchor, ``params_for(t, d)`` the decoded personal row, each with
        the fallback ladder of :meth:`gather`. The most recent
        ``cache_size`` principals' rows are cached (least recently used
        evicted). Returns a flat (S,) row (``layout.unflatten`` gives the
        parameter tree)."""
        if team is None:
            return self.global_row
        key = (int(team), None if device is None else int(device))
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            self._cache.move_to_end(key)
            return hit
        self.cache_misses += 1
        val = self.gather([key[0]], [-1 if device is None else key[1]])[0]
        self._cache[key] = val
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return val

    # ----------------------------------------------------- persistence

    def device_tier_nbytes(self) -> int:
        """Bytes of the encoded device tier, counted as the reference
        stores it: M*N*P values for ``"delta"`` / ``"raw"``; for
        ``"int8"`` one byte per value of each leaf padded to its 128-value
        rows plus a float32 scale per row."""
        mn = self.m * self.n
        if self.encoding == "int8":
            rows = segments(self.layout.leaf_sizes).rows
            return mn * rows * (LANES + 4)
        return mn * self.layout.size * self.payload.element_size()

    def as_tree(self) -> dict:
        """The three tiers as the reference's nested tree: ``{"global",
        "team", "device"}`` of per-leaf tensors with leading (), (M,),
        (M, N) axes; int8 leaves as ``{"q": (M, N, rows * 128) with zero
        padding, "scales": (M, N, rows)}``."""
        lay = self.layout
        tree = {"global": lay.unflatten(self.global_row),
                "team": lay.unflatten(self.team_rows)}
        if self.encoding != "int8":
            tree["device"] = lay.unflatten(self.payload)
            return tree
        q, scales = self.payload["q"], self.payload["scales"]
        segs = segments(lay.leaf_sizes)
        dev: dict = {}
        for path, o, p, r0 in zip(lay.paths, segs.offsets, segs.lengths,
                                  segs.row0):
            rows = -(-p // LANES)
            ql = q.new_zeros((self.m, self.n, rows * LANES))
            ql[..., :p] = q[..., o:o + p]
            node = dev
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = {"q": ql, "scales": scales[..., r0:r0 + rows]}
        tree["device"] = dev
        return tree

    def save(self, path: str):
        """Persist all three tiers and the layout metadata as one
        checkpoint in the reference's format and key paths."""
        with span("store_save", encoding=self.encoding):
            save_checkpoint(path, self.as_tree(), metadata={
                "kind": "model_store", "encoding": self.encoding,
                "m": self.m, "n": self.n, "cache_size": self.cache_size})

    @classmethod
    def load(cls, path: str, *, cache_size: int | None = None,
             device=DEFAULT_DEVICE):
        """Rebuild a store from :meth:`save` output (or the reference's)
        on ``device``: the layout comes from the global tier's key paths
        and shapes."""
        with span("store_load"):
            dev = resolve_device(device)
            arrays, meta = load_checkpoint_arrays(path)
            if meta.get("kind") != "model_store":
                raise ValueError(f"{path!r} is not a saved ModelStore "
                                 f"(metadata kind={meta.get('kind')!r})")
            root: dict = {}
            for key, arr in arrays.items():
                parts = key.split("/")
                node = root
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = arr.to(dev)
            m, n, enc = int(meta["m"]), int(meta["n"]), meta["encoding"]
            _check_encoding(enc)
            lay = Layout.of(root["global"])
            g = lay.flatten(root["global"])
            team = lay.flatten(root["team"], lead=(m,))
            if enc != "int8":
                payload = lay.flatten(root["device"], lead=(m, n))
            else:
                segs = segments(lay.leaf_sizes)
                q = torch.zeros((m, n, lay.stride), dtype=torch.int8,
                                device=dev)
                scales = torch.empty((m, n, segs.rows), dtype=torch.float32,
                                     device=dev)
                for path, o, p, r0 in zip(lay.paths, segs.offsets,
                                          segs.lengths, segs.row0):
                    node = root["device"]
                    for k in path:
                        node = node[k]
                    q[..., o:o + p] = node["q"][..., :p]
                    scales[..., r0:r0 + node["scales"].shape[-1]] = \
                        node["scales"]
                payload = {"q": q, "scales": scales}
            return cls(lay, g, team, payload, encoding=enc, m=m, n=n,
                       cache_size=(meta.get("cache_size", 64)
                                   if cache_size is None else cache_size))
