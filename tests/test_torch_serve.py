"""The port's personalized serving against the JAX package's
(``repro.serve``): from one JAX-trained PerMFL state (table1 MCLR at
2 teams x 3 devices, 1 round), carried across with
``convert.state_from_numpy``, the store's payloads and tiers, lookups
with tier fallback, served logits, the cached path, Zipf traffic and
replay tier counts; the export hook ``serving_params``; and the serve
CLI.

Stated tolerances:
* int8 decode is ``team + q * scale``. XLA on the CPU may fuse it into
  one multiply-add; the port rounds the product first (as its kernel
  path does). So an int8-decoded value may differ from JAX's by one
  rounding: ``INT8_DECODE_ULPS`` units of 2**-23 of the larger operand.
  The payloads themselves are compared exactly.
* Served logits against ``paper_models.apply`` of the trained rows: the
  models test's tolerances (``RTOL``, ``ATOL``): XLA's and torch's CPU
  matmuls sum in different orders.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import paper_models as JPM  # noqa: E402
from repro.scenarios import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.scenarios import build_scenario as j_build  # noqa: E402
from repro.scenarios import run_scenario as j_run  # noqa: E402
from repro.serve import store as JS  # noqa: E402
from repro.serve.personalized import PersonalizedServer as JServer  # noqa
from repro.serve.personalized import replay_traffic as j_replay  # noqa
from repro.serve.personalized import zipf_requests as j_zipf  # noqa: E402
from repro.serve.store import ModelStore as JStore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODINGS = ["delta", "int8", "raw"]
RTOL, ATOL = 1e-5, 1e-6
INT8_DECODE_ULPS = 2
SCENARIO = "table1/mnist/mclr/permfl"
# the keys of the reference's replay stats (its CLI prints them, less
# the raw latencies, plus the scenario)
JAX_STATS_KEYS = {
    "requests", "batch", "alpha", "unknown_frac", "cached", "encoding",
    "m", "n", "device_tier_bytes", "qps", "p50_ms", "p95_ms", "p99_ms",
    "mean_ms", "lat_ms", "tier_counts", "stage_gather_ms",
    "stage_forward_ms"}


@functools.lru_cache(maxsize=None)
def trained():
    """(JAX build, JAX state, port algo, port state, numpy input pool)."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import PerMFL, PerMFLHParams

    s = J_SCENARIOS[SCENARIO].scaled(m_teams=2, n_devices=3,
                                     samples_per_device=16, rounds=1)
    res = j_run(s, seed=0)
    b = j_build(s, seed=0)
    js = res.state
    state = state_from_numpy({k: jax.tree.map(np.asarray, getattr(js, k))
                              for k in ("x", "w", "theta")})
    xv = np.asarray(b.val["x"], np.float32)
    pool = xv.reshape((-1,) + xv.shape[3:])
    return b, js, PerMFL(None, PerMFLHParams()), state, pool


@functools.lru_cache(maxsize=None)
def stores(encoding):
    """(port store, JAX store) exported from the trained state."""
    from repro_torch.serve import ModelStore

    b, js, algo, state, _ = trained()
    return (ModelStore.from_state(algo, state, m=b.m, n=b.n,
                                  encoding=encoding),
            JStore.from_state(b.algo, js, m=b.m, n=b.n, encoding=encoding))


def _tree_equal(got, want):
    """Nested tensors / arrays: same key paths, dtypes, shapes, bits."""
    from repro_torch.flat import tree_leaves

    g = {p: v for p, v in tree_leaves(got)}
    w = {p: v for p, v in tree_leaves(jax.tree.map(np.asarray, want))}
    assert g.keys() == w.keys()
    for p in g:
        a = g[p].numpy() if isinstance(g[p], torch.Tensor) else g[p]
        assert a.dtype == w[p].dtype and a.shape == w[p].shape, p
        np.testing.assert_array_equal(a, w[p], err_msg="/".join(p))


def _port_cfg():
    from repro_torch.scenarios import get_scenario

    return get_scenario(SCENARIO).model_config()


def _port_apply(p, x):
    from repro_torch.models import paper_models as pm
    return pm.apply(p, _port_cfg(), x[:, None])[:, 0]


def _tags(m, n):
    """Every (team, device) pair, then unknown devices of known teams and
    unknown teams (negative and past the end)."""
    t = list(np.repeat(np.arange(m), n)) + [0, 1, m - 1, -1, m, m + 5, -2]
    d = list(np.tile(np.arange(n), m)) + [n, -1, n + 3, 0, 1, n + 1, -4]
    return np.asarray(t, np.int64), np.asarray(d, np.int64)


# ------------------------------------------------------------ the store

@pytest.mark.parametrize("encoding", ENCODINGS)
def test_store_tiers_equal_jax(encoding):
    """Every encoding's payload and tiers are bit-equal to JAX's
    ModelStore.from_state, leaf by leaf under its key paths, and the
    device tier counts the same bytes."""
    store, jstore = stores(encoding)
    _tree_equal(store.as_tree(), {"global": jstore.global_params,
                                  "team": jstore.team_params,
                                  "device": jstore.device_payload})
    assert store.device_tier_nbytes() == jstore.device_tier_nbytes()


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_gather_equals_jax(encoding):
    """Lookups with tier fallback on tags that include unknown devices
    and teams: exact for delta and raw, one rounding for int8."""
    from repro_torch.flat import tree_leaves

    store, jstore = stores(encoding)
    t, d = _tags(store.m, store.n)
    got = store.layout.unflatten(store.gather(t, d))
    want = jstore.gather(jnp.asarray(t), jnp.asarray(d))
    if encoding != "int8":
        _tree_equal(got, want)
        return
    team = store.layout.unflatten(store.team_rows[np.clip(t, 0, 1)])
    for (p, a), (_, b), (_, tm) in zip(tree_leaves(got), tree_leaves(
            jax.tree.map(np.asarray, want)), tree_leaves(team)):
        a, tm = a.numpy(), tm.numpy()
        size = np.maximum(np.abs(b), np.abs(b - tm))
        assert (np.abs(a - b) <= INT8_DECODE_ULPS * 2**-23 * size).all(), p


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_served_logits_equal_direct_apply(encoding):
    """serve(): one gather, one batched forward. delta / raw: the logits
    of paper_models.apply on the trained rows (theta[t, d], w[t] for an
    unknown device, x for an unknown team); int8: JAX's served logits."""
    from repro_torch.serve import PersonalizedServer

    b, js, _, _, pool = trained()
    store, jstore = stores(encoding)
    t, d = _tags(b.m, b.n)
    xs = pool[:len(t)]
    got = PersonalizedServer(store, _port_apply).serve(
        t, d, torch.from_numpy(xs)).numpy()
    if encoding == "int8":
        apply1 = lambda p, x: JPM.apply(p, b.config, x[None])[0]
        want = np.asarray(JServer(jstore, apply1).serve(t, d,
                                                        jnp.asarray(xs)))
    else:
        want = []
        for i, (ti, di) in enumerate(zip(t, d)):
            ok_t = 0 <= ti < b.m
            ok_d = ok_t and 0 <= di < b.n
            p = (b.algo.serving_params(js, int(ti), int(di)) if ok_d else
                 b.algo.serving_params(js, int(ti)) if ok_t else
                 b.algo.serving_params(js))
            want.append(np.asarray(JPM.apply(p, b.config, xs[i][None])[0]))
        want = np.stack(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_serve_equals_serve_cached(encoding):
    """The LRU path equals the in-batch path bit for bit, and both count
    the same tiers."""
    from repro_torch.serve import PersonalizedServer, ModelStore

    b, _, algo, state, pool = trained()
    store = ModelStore.from_state(algo, state, m=b.m, n=b.n,
                                  encoding=encoding, cache_size=4)
    t, d = _tags(b.m, b.n)
    t, d = np.concatenate([t, t[::-1]]), np.concatenate([d, d[::-1]])
    xs = torch.from_numpy(pool[np.arange(len(t)) % len(pool)])
    a, c = (PersonalizedServer(store, _port_apply) for _ in range(2))
    assert torch.equal(a.serve(t, d, xs), c.serve_cached(t, d, xs))
    assert a.tier_counts == c.tier_counts
    assert sum(a.tier_counts.values()) == len(t)
    assert store.cache_stats()["size"] == 4


def test_delta_decode_is_bit_exact_with_overflowing_differences():
    """Bit patterns whose int32 difference overflows (max float against
    -1.0, -inf against a positive value, NaN, -0.0) are stored as the
    reference's wrapped differences and decode to the device rows bit
    for bit."""
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.flat import Layout
    from repro_torch.serve import ModelStore

    m, n = 2, 3
    rng = np.random.default_rng(0)
    w = rng.standard_normal((m, 10)).astype(np.float32)
    theta = rng.standard_normal((m, n, 10)).astype(np.float32)
    special = np.array([np.finfo(np.float32).max, -np.inf, np.nan, -0.0,
                        1e-45], np.float32)
    anchor = np.array([-1.0, 3.0, -2.0, 0.0, -1e-45], np.float32)
    theta[0, 1, :5], w[0, :5] = special, anchor
    theta[1, 2, 5:], w[1, 5:] = -special, -anchor
    bits_t = theta.view(np.int32).astype(np.int64)
    bits_w = w.view(np.int32).astype(np.int64)[:, None]
    assert ((bits_t - bits_w) > 2**31 - 1).any()
    assert ((bits_t - bits_w) < -2**31).any()
    lay = Layout.of({"v": torch.zeros(10)})
    rows = lambda a: lay.flatten({"v": torch.from_numpy(a)},
                                 lead=a.shape[:-1])
    state = dataclasses.make_dataclass("S", ["x", "w", "theta", "layout"])(
        rows(w[0]), rows(w), rows(theta), lay)
    store = ModelStore.from_state(PerMFL(None, PerMFLHParams()), state, m=m,
                                  n=n)
    jpay = JS._encode_device_tier({"v": jnp.asarray(theta)},
                                  {"v": jnp.asarray(w)}, "delta")
    np.testing.assert_array_equal(
        store.as_tree()["device"]["v"].numpy(), np.asarray(jpay["v"]))
    t, d = np.repeat(np.arange(m), n), np.tile(np.arange(n), m)
    got = store.gather(t, d)[:, :10].contiguous()
    assert torch.equal(got.view(torch.int32),
                       torch.from_numpy(theta.reshape(m * n, 10))
                       .view(torch.int32))


def test_unknown_encoding_rejected():
    from repro_torch.serve import ModelStore

    b, _, algo, state, _ = trained()
    with pytest.raises(ValueError, match="encoding"):
        ModelStore.from_state(algo, state, m=b.m, n=b.n, encoding="gzip")


def test_params_for_walks_the_ladder_and_caches():
    """params_for: the gather's rows for a device, a team, an unknown
    device and the global tier; LRU hits, misses and eviction."""
    from repro_torch.serve import ModelStore

    b, _, algo, state, _ = trained()
    store = ModelStore.from_state(algo, state, m=b.m, n=b.n, cache_size=2)
    assert torch.equal(store.params_for(), state.x)
    assert torch.equal(store.params_for(1), state.w[1])
    assert torch.equal(store.params_for(1, b.n + 2), state.w[1])
    assert torch.equal(store.params_for(0, 2), state.theta[0, 2])
    assert store.cache_stats() == {"hits": 0, "misses": 3,
                                   "hit_rate": 0.0, "size": 2}
    store.params_for(0, 2)
    store.params_for(1)                   # evicted by (1, n + 2), (0, 2)
    st = store.cache_stats()
    assert (st["hits"], st["misses"], st["size"]) == (1, 4, 2)
    store.reset_cache_stats()
    assert store.cache_stats()["hits"] == 0 == store.cache_stats()["misses"]


def test_serving_params_tiers():
    """PerMFL.serving_params: x, w[t], theta[t, d], and stacked rows for
    index tensors; the base default serves one global row to all."""
    from repro_torch.core import FLAlgorithmBase

    b, _, algo, state, _ = trained()
    assert torch.equal(algo.serving_params(state), state.x)
    assert torch.equal(algo.serving_params(state, 1), state.w[1])
    assert torch.equal(algo.serving_params(state, 1, 2), state.theta[1, 2])
    ts, ds = torch.arange(b.m), torch.arange(b.n)
    assert torch.equal(algo.serving_params(state, ts), state.w)
    assert torch.equal(algo.serving_params(state, ts[:, None], ds[None]),
                       state.theta)
    row = state.x
    base = FLAlgorithmBase()
    assert base.serving_params(row) is row
    assert torch.equal(base.serving_params(row, ts[:, None], ds[None]),
                       row.expand(b.m, b.n, -1))


# ------------------------------------------------------ traffic, replay

@pytest.mark.parametrize("kw", [
    dict(m=2, n=3, count=512), dict(m=4, n=10, count=300, alpha=1.5,
                                    unknown_frac=0.1, seed=3),
    dict(m=7, n=5, count=64, alpha=2.0, unknown_frac=0.5, seed=11)])
def test_zipf_requests_equal_jax(kw):
    from repro_torch.serve import zipf_requests

    got, want = zipf_requests(**kw), j_zipf(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_replay_tier_counts_equal_jax():
    """A replay with unknown principals: the port's tier counts (batched
    and cached) equal the reference's and sum to the requests; the
    port's stats carry every key of the reference's."""
    from repro_torch.serve import PersonalizedServer, replay_traffic

    b, _, _, _, pool = trained()
    store, jstore = stores("delta")
    kw = dict(requests=200, batch=32, alpha=1.3, unknown_frac=0.2, seed=5)
    apply1 = lambda p, x: JPM.apply(p, b.config, x[None])[0]
    want = j_replay(JServer(jstore, apply1), pool, **kw)
    assert set(want) == JAX_STATS_KEYS
    for cached in (False, True):
        got = replay_traffic(PersonalizedServer(store, _port_apply),
                             torch.from_numpy(pool), cached=cached, **kw)
        assert got["tier_counts"] == want["tier_counts"]
        assert sum(got["tier_counts"].values()) == got["requests"] == 192
        assert JAX_STATS_KEYS <= set(got)
        assert got["device"] == "cpu"
        assert got["device_tier_bytes"] == want["device_tier_bytes"]


def test_cli_serve_on_cpu(tmp_path):
    """The serve command end to end on the CPU with an int8 store saved,
    reloaded and served through the LRU: the stats keys the reference's
    CLI prints, and the tier counts sum to the requests."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "serve", SCENARIO,
         "--smoke", "--device", "cpu", "--json", "--encoding", "int8",
         "--store", str(tmp_path / "store.ckpt"), "--cached",
         "--unknown-frac", "0.1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith(f"# store: {tmp_path / 'store.ckpt'} (int8")
    stats = json.loads(lines[-1])
    assert (JAX_STATS_KEYS - {"lat_ms"}) | {"scenario"} <= set(stats)
    assert stats["encoding"] == "int8" and stats["cached"] is True
    assert sum(stats["tier_counts"].values()) == stats["requests"] == 512
    assert stats["device"] == "cpu"
