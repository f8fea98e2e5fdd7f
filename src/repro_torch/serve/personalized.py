"""Batched personalized inference over (team, device)-tagged requests.

The serving half of the store: a :class:`PersonalizedServer` wraps a
:class:`repro_torch.serve.store.ModelStore` and a batched forward, and
answers request batches where every row carries its own ``(team,
device)`` tag. :meth:`PersonalizedServer.serve` is one tier-fallback
gather of every request's parameter row, then ONE batched forward in
which each request row is its own model with a batch of one (the port's
``paper_models.apply`` is batched over a leading model axis) -- so a
64-request batch over 64 different personalized models is one forward,
not 64.

:meth:`PersonalizedServer.serve_cached` answers the same question
through the store's host-side LRU: it collapses the batch to its unique
principals, takes each one's decoded row from the LRU (hot devices skip
decode), and stacks. Both give the same outputs bit for bit under the
exact encodings (``"delta"`` / ``"raw"``); under ``"int8"`` too, since
both decode with the same ops. :func:`replay_traffic` replays
Zipf-skewed traffic -- real traffic's popularity -- through either and
measures p50/p95/p99 latency and queries per second on the store's
device, each timed batch ending in a device synchronize, and, given a
``repro_torch.obs.MetricsRegistry``, publishes them under the
reference's metric names; the replay, its batches and its stage split
run in spans (``repro_torch.obs.spans``).
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.obs.spans import span
from repro_torch.serve.store import ModelStore

__all__ = ["PersonalizedServer", "replay_traffic", "zipf_requests"]

TIERS = ("device", "team", "global")


class PersonalizedServer:
    """Batched tier-resolved inference in front of a :class:`ModelStore`.

    ``apply_fn(params, xs) -> outputs`` is the batched forward: parameter
    leaves (B, ...), one model per row, and inputs (B, ...), one example
    per row, give (B, ...) outputs (for the paper models
    ``lambda p, x: paper_models.apply(p, cfg, x[:, None])[:, 0]``).
    """

    def __init__(self, store: ModelStore,
                 apply_fn: Callable[[Any, Any], Any]):
        """Wrap ``store`` and a batched ``apply_fn``."""
        self.store = store
        self.apply_fn = apply_fn
        self.tier_counts = dict.fromkeys(TIERS, 0)

    def reset_tier_counts(self) -> None:
        """Zero the accumulated tier-resolution counts (call after
        warm-up so timed traffic reports clean counts)."""
        self.tier_counts = dict.fromkeys(TIERS, 0)

    @torch.no_grad()
    def forward(self, rows, xs):
        """The batched forward of (B, S) parameter rows on (B, ...)
        inputs."""
        return self.apply_fn(self.store.layout.unflatten(rows), xs)

    def _tags(self, teams, devices):
        dev = self.store.device
        return (torch.as_tensor(np.asarray(teams), dtype=torch.int64,
                                device=dev),
                torch.as_tensor(np.asarray(devices), dtype=torch.int64,
                                device=dev))

    @torch.no_grad()
    def serve(self, teams, devices, xs):
        """Answer a request batch: teams / devices (B,) integer tags
        (out of range falls down the tier ladder device -> team ->
        global), xs (B, ...) inputs on the store's device. Returns (B,
        ...) outputs, row i under request i's resolved parameters; the
        batch's tier counts accumulate onto :attr:`tier_counts`."""
        t, d = self._tags(teams, devices)
        out = self.forward(self.store.gather(t, d), xs)
        tiers = self.store.resolve_tiers(t, d)
        counts = torch.stack([tiers[k] for k in TIERS]).tolist()
        for k, c in zip(TIERS, counts):
            self.tier_counts[k] += int(c)
        return out

    @torch.no_grad()
    def serve_cached(self, teams, devices, xs):
        """Answer a request batch through the store's LRU: collapse the
        batch to its unique (team, device) principals, take each one's
        decoded row from :meth:`ModelStore.params_for`, stack, and run
        the same batched forward. Outputs equal :meth:`serve`'s."""
        t = np.asarray(teams, np.int64)
        d = np.asarray(devices, np.int64)
        # the ladder of ModelStore.resolve_tiers, on the host (the batch
        # never goes through gather on this path)
        ok_t = (t >= 0) & (t < self.store.m)
        ok_d = ok_t & (d >= 0) & (d < self.store.n)
        self.tier_counts["device"] += int(ok_d.sum())
        self.tier_counts["team"] += int((ok_t & ~ok_d).sum())
        self.tier_counts["global"] += int((~ok_t).sum())
        pairs, inverse = np.unique(np.stack([t, d], axis=1), axis=0,
                                   return_inverse=True)
        uniq = torch.stack([self.store.params_for(int(a), int(b))
                            for a, b in pairs])
        idx = torch.as_tensor(inverse.reshape(-1), device=uniq.device)
        return self.forward(uniq[idx], xs)


def zipf_requests(m: int, n: int, count: int, *, alpha: float = 1.2,
                  unknown_frac: float = 0.0, seed: int = 0):
    """Zipf-skewed request tags over an ``m x n`` device population, the
    reference's numpy draws (the same arrays for the same arguments).

    Device popularity rank is drawn from a Zipf(``alpha``) law and
    mapped onto the population through a fixed random permutation (the
    hot set is scattered across teams). A ``unknown_frac`` share of
    requests is tagged with an out-of-range device (and half of those
    with an out-of-range team) to exercise the fallback ladder. Returns
    ``(teams, devices)`` int64 arrays of length ``count``.
    """
    rng = np.random.default_rng(seed)
    population = m * n
    ranks = (rng.zipf(alpha, size=count) - 1) % population
    flat = rng.permutation(population)[ranks]
    teams, devices = flat // n, flat % n
    if unknown_frac > 0.0:
        bad = rng.random(count) < unknown_frac
        devices = np.where(bad, n + 1, devices)
        teams = np.where(bad & (rng.random(count) < 0.5), m + 1, teams)
    return teams.astype(np.int64), devices.astype(np.int64)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def replay_traffic(server: PersonalizedServer, inputs, *,
                   requests: int = 512, batch: int = 64,
                   alpha: float = 1.2, unknown_frac: float = 0.0,
                   seed: int = 0, cached: bool = False,
                   metrics=None) -> dict:
    """Replay Zipf-popularity traffic and measure serving latency.

    Draws ``requests`` tags via :func:`zipf_requests`, pairs each with a
    row of ``inputs`` (a (P, ...) pool, numpy or tensor) drawn as the
    reference draws it, and serves them in ``batch``-size steps through
    :meth:`PersonalizedServer.serve` (or ``serve_cached``). The first
    batch is served once untimed (warm-up), then the tier and LRU
    counters are reset so the report covers exactly the timed traffic;
    each timed batch runs from a synchronized device to a synchronized
    device on the host clock. A second pass times the gather-decode and
    the forward stages apart over the same batches.

    Returns ``qps``, ``p50_ms`` / ``p95_ms`` / ``p99_ms``, ``mean_ms``,
    the per-batch latencies (``lat_ms``), ``tier_counts`` (summing to
    ``requests``), the stage split (``stage_gather_ms`` /
    ``stage_forward_ms`` means), ``cache_hit_rate`` on cached runs, the
    workload knobs, the encoded device-tier size and the ``device`` it
    ran on. When ``metrics`` (a ``repro_torch.obs.MetricsRegistry``) is
    given, the same telemetry is published into it as the reference
    publishes it: ``serving.requests``, ``serving.tier.<tier>``, the
    latency and stage histograms, and on cached runs the LRU counters
    and the hit-rate gauge.
    """
    store = server.store
    dev = store.device
    requests = max(batch, (requests // batch) * batch)
    teams, devices = zipf_requests(store.m, store.n, requests, alpha=alpha,
                                   unknown_frac=unknown_frac, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pool = torch.as_tensor(inputs, device=dev)
    pick = rng.integers(0, pool.shape[0], size=requests)
    xs = pool[torch.as_tensor(pick, device=dev)]
    step = server.serve_cached if cached else server.serve

    with span("replay", requests=requests, batches=requests // batch,
              cached=bool(cached)):
        step(teams[:batch], devices[:batch], xs[:batch])
        synchronize(dev)
        server.reset_tier_counts()
        store.reset_cache_stats()
        lat = []
        t_all = time.perf_counter()
        for lo in range(0, requests, batch):
            hi = lo + batch
            with span("replay_batch", lo=lo):
                t0 = time.perf_counter()
                step(teams[lo:hi], devices[lo:hi], xs[lo:hi])
                synchronize(dev)
                lat.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all

    lat_ms = np.asarray(lat) * 1e3
    lat_sorted = np.sort(lat_ms)

    def pct(p):
        return float(lat_sorted[min(len(lat_sorted) - 1,
                                    int(np.ceil(p / 100 * len(lat_sorted)))
                                    - 1)])

    # stage split: gather-decode vs forward, over the same batches
    with torch.no_grad(), span("replay_stages", batches=requests // batch):
        server.forward(store.gather(teams[:batch], devices[:batch]),
                       xs[:batch])
        synchronize(dev)
        g_ms, f_ms = [], []
        for lo in range(0, requests, batch):
            hi = lo + batch
            t0 = time.perf_counter()
            rows = store.gather(teams[lo:hi], devices[lo:hi])
            synchronize(dev)
            t1 = time.perf_counter()
            server.forward(rows, xs[lo:hi])
            synchronize(dev)
            t2 = time.perf_counter()
            g_ms.append((t1 - t0) * 1e3)
            f_ms.append((t2 - t1) * 1e3)

    stats = {
        "requests": requests, "batch": batch, "alpha": alpha,
        "unknown_frac": unknown_frac, "cached": bool(cached),
        "encoding": store.encoding, "m": store.m, "n": store.n,
        "device_tier_bytes": store.device_tier_nbytes(),
        "qps": float(requests / total),
        "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
        "mean_ms": float(lat_ms.mean()),
        "lat_ms": [float(v) for v in lat_ms],
        "tier_counts": dict(server.tier_counts),
        "stage_gather_ms": float(np.mean(g_ms)),
        "stage_forward_ms": float(np.mean(f_ms)),
        "device": _device_name(dev),
    }
    if cached:
        stats["cache_hit_rate"] = store.cache_stats()["hit_rate"]

    if metrics is not None:
        metrics.counter("serving.requests").inc(requests)
        for tier, cnt in stats["tier_counts"].items():
            metrics.counter(f"serving.tier.{tier}").inc(cnt)
        h = metrics.histogram("serving.replay.latency_ms")
        for v in lat_ms:
            h.observe(float(v))
        hg = metrics.histogram("serving.stage.gather_ms")
        hf = metrics.histogram("serving.stage.forward_ms")
        for g, f in zip(g_ms, f_ms):
            hg.observe(g)
            hf.observe(f)
        if cached:
            cs = store.cache_stats()
            metrics.counter("serving.lru.hits").inc(cs["hits"])
            metrics.counter("serving.lru.misses").inc(cs["misses"])
            metrics.gauge("serving.cache_hit_rate").set(cs["hit_rate"])
    return stats
