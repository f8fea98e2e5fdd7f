"""The port's cohort engine (``repro_torch.train.store``, the engine's
``cohort=`` mode) against the JAX package's (``repro.train.store``,
``repro.train.engine``) and against the port's own stacked path.

- The store: sorted, distinct, in-range index maps (``sample_cohort``,
  ``arange(n)`` at full width); gather and scatter held against the
  reference's on the reference's maps; scatter after gather an exact,
  in-place round trip; rows never sampled bit-unchanged; permutation
  equivariance; a sweep's (C, M, c) maps along dim 2. A seeded grid and,
  over the same checks, hypothesis.
- ``device_axes``: the reference's flags for PerMFL (with and without
  comm) and the six baselines, and the default shape rule.
- The engine at c < n, fed the reference's cohort maps and masks: PerMFL,
  PerMFL with top-k, FedAvg and Ditto within the round tolerances of
  ROADMAP.md queue 3 (rtol 1e-4; atol 1e-5 after 1 round, 1e-4 after
  3), the realized participation and ledger bytes exactly.
- c == n bit-equal to the port's stacked path (histories, states,
  participation, ledger, timeline); never-sampled devices' EF residuals
  zero; eval cadence with a remainder; a mask stream no cohort moves;
  validation; sweep lanes equal to their solo runs; bounded eval (chunks
  smaller than N) bit-equal to one call; the cohort cells through the
  scenario layer and the CLI.

Sizes: the reference's quad fixture (3 teams x 6 devices, 5 parameters,
cohort 4) and a 1-round ``cohort/virtual/n1000``.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.comm import CommConfig as JCommConfig  # noqa: E402
from repro.core import PerMFL as JPerMFL  # noqa: E402
from repro.core import PerMFLHParams as JHParams  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core.participation import sample_cohort as j_sample_cohort  # noqa: E402,E501
from repro.core.participation import sample_masks as j_sample_masks  # noqa: E402,E501
from repro.train import store as JST  # noqa: E402
from repro.train.engine import run_experiment as j_run  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False

M, N, D = 3, 6, 5
COHORT = 4
HP = dict(alpha=0.05, eta=0.04, beta=0.3, lam=0.8, gamma=2.0, k_team=3,
          l_local=4)
# ROADMAP.md queue 3: rounds at rtol 1e-4, atol 1e-5 (1 round) / 1e-4 (3)
TOL = {1: dict(rtol=1e-4, atol=1e-5), 3: dict(rtol=1e-4, atol=1e-4)}


def j_quad(params, batch):
    return 0.5 * jnp.sum((params["p"] - batch["c"]) ** 2)


def j_neg(params, batch):
    return -j_quad(params, batch)


def quad(params, batch):
    """The port's quad loss: per-device (D,) from leaves (D, ...)."""
    return 0.5 * ((params["p"] - batch["c"]) ** 2).sum(-1)


def neg(params, batch):
    return -quad(params, batch)


@pytest.fixture(scope="module")
def quad_data():
    rng = np.random.default_rng(0)
    return {"c": rng.normal(size=(M, N, D)).astype(np.float32)}


P0 = {"p": np.zeros(D, np.float32)}


def port_algos():
    from repro_torch.comm import CommConfig
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.core import baselines as B

    hp = PerMFLHParams(**HP)
    return {
        "permfl": PerMFL(quad, hp),
        "permfl_comm": PerMFL(quad, hp, comm=CommConfig("topk", k_frac=0.4)),
        "fedavg": B.FedAvg(quad, lr=0.1, local_steps=3),
        "ditto": B.Ditto(quad, lr=0.05, lam=0.5, local_steps=3),
    }


def jax_algos():
    hp = JHParams(**HP)
    return {
        "permfl": JPerMFL(j_quad, hp),
        "permfl_comm": JPerMFL(j_quad, hp,
                               comm=JCommConfig("topk", k_frac=0.4)),
        "fedavg": JB.FedAvg(j_quad, lr=0.1, local_steps=3),
        "ditto": JB.Ditto(j_quad, lr=0.05, lam=0.5, local_steps=3),
    }


def run(algo, data, **kw):
    from repro_torch.train.engine import run_experiment
    kw = dict(dict(metric_fn=neg, m=M, n=N, device="cpu"), **kw)
    return run_experiment(algo, P0, data, data, **kw)


def assert_bit_equal(a, b):
    """Two of the port's runs: histories, state, participation, ledger
    and timeline equal to the bit."""
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        assert getattr(a, f) == getattr(b, f), f
    assert_states_equal(a.state, b.state)
    if a.comm is not None or b.comm is not None:
        assert a.comm.totals() == b.comm.totals()
    if a.timeline is not None or b.timeline is not None:
        assert a.timeline == b.timeline and a.sim_seconds == b.sim_seconds


def assert_states_equal(a, b):
    from repro_torch.train.store import state_fields

    fa, fb = dict(state_fields(a)), dict(state_fields(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        elif not isinstance(v, torch.Generator):
            assert v == fb[k], k


def _tree(rng, m, n):
    """A device tier with leaves of varying trailing shapes."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"a": f32(m, n), "b": f32(m, n, 3), "c": f32(m, n, 2, 2)}


def _port_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# ---------------------------------------------------------------- store

# (m, n, c, seed): the edges c = 1, c = n, n = 1
GRID = [(1, 1, 1, 0), (2, 5, 1, 1), (2, 5, 3, 2), (3, 8, 8, 3),
        (3, 8, 5, 4), (2, 7, 6, 5)]


def _check_index_map(m, n, c, seed):
    from repro_torch.core.participation import sample_cohort

    idx = sample_cohort(torch.Generator().manual_seed(seed), m, n, c)
    assert tuple(idx.shape) == (m, c) and idx.dtype == torch.int64
    for row in idx.numpy():
        assert (np.diff(row) > 0).all()          # sorted, so distinct
        assert row.min() >= 0 and row.max() < n


def _check_roundtrip(m, n, c, seed):
    """The port's gather and scatter equal the reference's on the
    reference's map; scatter after gather is the identity, in place."""
    from repro_torch.train.store import gather_cohort, scatter_cohort

    tree = _tree(np.random.default_rng(seed), m, n)
    jidx = j_sample_cohort(jax.random.PRNGKey(seed), m, n, c)
    idx = torch.from_numpy(np.asarray(jidx).astype(np.int64))
    pt = _port_tree(tree)
    got = gather_cohort(pt, idx)
    want = JST.gather_cohort(jax.tree.map(jnp.asarray, tree), jidx)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    ptrs = {k: v.data_ptr() for k, v in pt.items()}
    out = scatter_cohort(pt, idx, got)
    for k in tree:
        assert out[k].data_ptr() == ptrs[k]              # in place
        np.testing.assert_array_equal(out[k].numpy(), tree[k])


def _check_untouched_rows(m, n, c, seed):
    from repro_torch.train.store import gather_cohort, scatter_cohort

    tree = _tree(np.random.default_rng(seed), m, n)
    jidx = j_sample_cohort(jax.random.PRNGKey(seed), m, n, c)
    idx = torch.from_numpy(np.asarray(jidx).astype(np.int64))
    update = {k: v + 1.0 for k, v in gather_cohort(_port_tree(tree),
                                                   idx).items()}
    out = scatter_cohort(_port_tree(tree), idx, update)
    want = JST.scatter_cohort(
        jax.tree.map(jnp.asarray, tree), jidx,
        jax.tree.map(lambda u: jnp.asarray(u.numpy()), update))
    for k in tree:
        a, b = out[k].numpy(), tree[k]
        np.testing.assert_array_equal(a, np.asarray(want[k]))
        for t in range(m):
            sampled = np.zeros(n, bool)
            sampled[idx[t].numpy()] = True
            np.testing.assert_array_equal(a[t][~sampled], b[t][~sampled])
            np.testing.assert_array_equal(a[t][sampled], b[t][sampled] + 1)


def _check_permutation_equivariance(m, n, c, seed, perm=None):
    from repro_torch.core.participation import sample_cohort
    from repro_torch.train.store import gather_cohort

    if perm is None:
        perm = np.random.default_rng(seed + 1).permutation(c)
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64)
    tree = _port_tree(_tree(np.random.default_rng(seed), m, n))
    idx = sample_cohort(torch.Generator().manual_seed(seed), m, n, c)
    direct = gather_cohort(tree, idx[:, perm])
    reordered = {k: v[:, perm] for k, v in gather_cohort(tree, idx).items()}
    for k in tree:
        assert torch.equal(direct[k], reordered[k])


@pytest.mark.parametrize("m,n,c,seed", GRID)
def test_sample_cohort_sorted_unique_in_range(m, n, c, seed):
    _check_index_map(m, n, c, seed)


def test_sample_cohort_full_width_is_arange():
    from repro_torch.core.participation import sample_cohort

    for seed, (m, n) in enumerate(((1, 1), (2, 5), (3, 8))):
        idx = sample_cohort(torch.Generator().manual_seed(seed), m, n, n)
        assert torch.equal(idx, torch.arange(n).expand(m, n))


@pytest.mark.parametrize("m,n,c,seed", GRID)
def test_scatter_after_gather_is_identity(m, n, c, seed):
    _check_roundtrip(m, n, c, seed)


@pytest.mark.parametrize("m,n,c,seed", GRID)
def test_scatter_touches_only_sampled_rows(m, n, c, seed):
    _check_untouched_rows(m, n, c, seed)


@pytest.mark.parametrize("m,n,c,seed", GRID)
def test_gather_is_permutation_equivariant(m, n, c, seed):
    _check_permutation_equivariance(m, n, c, seed)


if HAVE_HYPOTHESIS:
    _SMALL = dict(m=st.integers(1, 3), n=st.integers(1, 8),
                  seed=st.integers(0, 999))

    @settings(max_examples=20, deadline=None)
    @given(data=st.data(), **_SMALL)
    def test_hypothesis_index_map(data, m, n, seed):
        _check_index_map(m, n, data.draw(st.integers(1, n)), seed)

    @settings(max_examples=15, deadline=None)
    @given(data=st.data(), **_SMALL)
    def test_hypothesis_roundtrip(data, m, n, seed):
        _check_roundtrip(m, n, data.draw(st.integers(1, n)), seed)

    @settings(max_examples=15, deadline=None)
    @given(data=st.data(), **_SMALL)
    def test_hypothesis_untouched_rows(data, m, n, seed):
        _check_untouched_rows(m, n, data.draw(st.integers(1, n)), seed)

    @settings(max_examples=20, deadline=None)
    @given(data=st.data(), **_SMALL)
    def test_hypothesis_permutation_equivariance(data, m, n, seed):
        c = data.draw(st.integers(1, n))
        perm = data.draw(st.permutations(range(c)))
        _check_permutation_equivariance(m, n, c, seed, perm=perm)


def test_stacked_maps_gather_along_dim_2():
    """A sweep's store: (C, M, N, ...) tiers, (C, M, c) maps; each
    config's slab is its own gather, and scatter writes it back."""
    from repro_torch.core.participation import sample_cohort
    from repro_torch.train.store import gather_cohort, scatter_cohort

    rng = np.random.default_rng(3)
    tier = torch.from_numpy(rng.normal(size=(2, M, N, D)).astype(np.float32))
    idx = torch.stack([sample_cohort(torch.Generator().manual_seed(s), M,
                                     N, COHORT) for s in (0, 1)])
    got = gather_cohort(tier, idx)
    for i in range(2):
        assert torch.equal(got[i], gather_cohort(tier[i], idx[i]))
    before = tier.clone()
    scatter_cohort(tier, idx, got * 2.0)
    for i in range(2):
        for t in range(M):
            rows = idx[i, t]
            assert torch.equal(tier[i, t, rows], 2.0 * before[i, t, rows])
            keep = torch.ones(N, dtype=torch.bool)
            keep[rows] = False
            assert torch.equal(tier[i, t, keep], before[i, t, keep])


def test_device_state_store_methods():
    from repro_torch.core.participation import sample_cohort
    from repro_torch.train.store import DeviceStateStore, gather_cohort

    tree = _port_tree(_tree(np.random.default_rng(7), M, N))
    store = DeviceStateStore(tree, M, N)
    idx = sample_cohort(torch.Generator().manual_seed(0), M, N, 2)
    cohort = store.gather(idx)
    want = gather_cohort(tree, idx)
    assert all(torch.equal(cohort[k], want[k]) for k in tree)
    assert store.scatter(idx, {k: v * 2 for k, v in cohort.items()}) \
        is store
    for k in tree:
        assert torch.equal(gather_cohort(store.tree, idx)[k], 2 * want[k])


# ----------------------------------------------------------- device_axes

def _ref_device_fields(jalgo, jstate):
    """The reference's device-tier flags as the port's dotted names."""
    flags = jalgo.device_axes(jstate, M, N)
    on = lambda tree: all(jax.tree.leaves(tree))          # noqa: E731
    if hasattr(flags, "theta"):
        names = {k for k in ("x", "w", "theta") if on(getattr(flags, k))}
        if flags.round:
            names.add("round")
        if flags.comm is not None:
            for k, port in (("ef_dev", "comm.ef_dev"),
                            ("ef_team", "comm.ef_team"),
                            ("key", "comm.gen")):
                if on(getattr(flags.comm, k)):
                    names.add(port)
        return names
    if isinstance(flags, tuple):
        # (x, personal): every leaf of the reference maps to a field of
        # BaselineState (it holds no device-tier leaf the port lacks)
        assert len(flags) == 2
        return {n for n, f in zip(("x", "personal"), flags) if on(f)}
    return {"x"} if on(flags) else set()


BASELINE_KW = {
    "FedAvg": dict(lr=0.1, local_steps=2),
    "PerFedAvg": dict(lr=0.1, inner_lr=0.05, local_steps=2),
    "PFedMe": dict(lr=0.5, inner_lr=0.05, lam=2.0, inner_steps=2,
                   local_rounds=2),
    "Ditto": dict(lr=0.1, lam=0.5, local_steps=2),
    "HSGD": dict(lr=0.1, k_team=2, l_local=2),
    "L2GD": dict(lr=0.1, lam_c=0.5, lam_g=0.5, k_team=2, l_local=2),
}


@pytest.mark.parametrize("name", ["permfl", "permfl_comm"]
                         + sorted(BASELINE_KW))
def test_device_axes_match_the_reference(name):
    from repro_torch.core import baselines as B
    from repro_torch.core.algorithm import FLAlgorithmBase
    from repro_torch.train.store import split_device_state

    if name.startswith("permfl"):
        algo, jalgo = port_algos()[name], jax_algos()[name]
    else:
        algo = getattr(B, name)(quad, **BASELINE_KW[name])
        jalgo = getattr(JB, name)(j_quad, **BASELINE_KW[name])
    from repro_torch.convert import params_from_numpy
    state = algo.init_state(params_from_numpy(P0), M, N)
    jstate = jalgo.init_state(jax.tree.map(jnp.asarray, P0), M, N)
    want = _ref_device_fields(jalgo, jstate)
    assert set(algo.device_axes(state, M, N)) == want
    # the default shape rule picks the same fields here (no dimension of
    # the model equals N)
    assert set(FLAlgorithmBase.device_axes(algo, state, M, N)) == want
    dev, rest, merge = split_device_state(algo, state, M, N)
    assert set(dev) == want
    assert_states_equal(merge(dev, rest), state)


def test_split_refuses_a_field_that_is_not_device_tier():
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import PerMFL
    from repro_torch.train.store import split_device_state

    class Bad(PerMFL):
        def device_axes(self, state, m, n):
            return ("w",)                         # (M, S): not per device

    algo = port_algos()["permfl"]
    state = algo.init_state(params_from_numpy(P0), M, N)
    with pytest.raises(ValueError, match="not a device-tier field"):
        split_device_state(Bad(quad, algo.hp), state, M, N)


# --------------------------------------------- the engine at c < n vs JAX

def _ref_arrays(name, state):
    """name -> numpy array of a reference or port final state."""
    from repro_torch.convert import to_numpy

    if hasattr(state, "layout"):                          # the port's
        s = to_numpy(state)
    else:
        s = jax.tree.map(np.asarray, state)
        if hasattr(s, "theta"):
            s = {"x": s.x, "w": s.w, "theta": s.theta,
                 **({"comm": {"ef_dev": s.comm.ef_dev,
                              "ef_team": s.comm.ef_team}}
                    if s.comm is not None else {})}
    if name.startswith("permfl"):
        out = {k: s[k]["p"] for k in ("x", "w", "theta")}
        if "comm" in s:
            out.update({k: v["p"] for k, v in s["comm"].items()})
        return out
    if isinstance(s, tuple):
        return {"x": s[0]["p"], "personal": s[1]["p"]}
    return {"x": s["p"]}


def _jax_mask_chain(seed, rounds, width, team_frac, device_frac):
    """The reference engine's masks at width ``width``: the carried key
    split once a round."""
    key, chain = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        chain.append(tuple(np.asarray(a) for a in j_sample_masks(
            sub, M, width, team_frac=team_frac, device_frac=device_frac)))
    return chain


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("name", ["permfl", "permfl_comm", "fedavg",
                                  "ditto"])
def test_cohort_engine_matches_the_reference(quad_data, name, rounds):
    sampled = name.startswith("permfl")
    frac = dict(team_frac=0.67, device_frac=0.75) if sampled else {}
    jres = j_run(jax_algos()[name], jax.tree.map(jnp.asarray, P0),
                 jax.tree.map(jnp.asarray, quad_data),
                 jax.tree.map(jnp.asarray, quad_data), metric_fn=j_neg,
                 rounds=rounds, m=M, n=N, seed=7, cohort=COHORT, **frac)
    masks = None
    if sampled:
        masks = _jax_mask_chain(7, rounds, COHORT, **frac).__getitem__
    res = run(port_algos()[name], quad_data, rounds=rounds, seed=7,
              cohort=COHORT, masks=masks,
              cohort_indices=lambda t: jres.cohort_indices[t], **frac)
    assert res.cohort_indices == jres.cohort_indices
    assert res.participation == jres.participation
    assert (res.cohort, res.population) == (COHORT, N)
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss"):
        np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                   **TOL[rounds], err_msg=f)
    got, want = _ref_arrays(name, res.state), _ref_arrays(name, jres.state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL[rounds],
                                   err_msg=k)
    if jres.comm is not None:
        assert vars(res.comm.totals()) == vars(jres.comm.totals())


# ------------------------------------------------- the port against itself

@pytest.mark.parametrize("name", ["permfl", "permfl_comm", "fedavg",
                                  "ditto"])
def test_full_width_cohort_is_the_stacked_run(quad_data, name):
    algo = port_algos()[name]
    kw = dict(rounds=5, seed=3)
    stacked = run(algo, quad_data, **kw)
    cohort = run(algo, quad_data, cohort=N, **kw)
    assert_bit_equal(stacked, cohort)
    assert (cohort.cohort, cohort.population) == (N, N)
    assert stacked.cohort is None and stacked.cohort_indices == []
    for per_round in cohort.cohort_indices:
        assert per_round == [list(range(N))] * M


def test_full_width_cohort_is_the_stacked_run_sampled_comm_system(
        quad_data):
    """Sampled masks, compressed uplinks and a system model ride the
    identity gather: every stream and the timeline bit-equal."""
    algo = port_algos()["permfl_comm"]
    kw = dict(rounds=4, seed=11, team_frac=0.67, device_frac=0.75,
              system="wan-cellular")
    stacked = run(algo, quad_data, **kw)
    cohort = run(algo, quad_data, cohort=N, **kw)
    assert_bit_equal(stacked, cohort)
    assert len(cohort.timeline) == 4 and len(cohort.comm.rounds) == 4


def test_never_sampled_ef_rows_stay_zero(quad_data):
    res = run(port_algos()["permfl_comm"], quad_data, rounds=3, seed=4,
              cohort=2)
    sampled = [set() for _ in range(M)]
    for per_round in res.cohort_indices:
        for t, row in enumerate(per_round):
            sampled[t].update(row)
    ef = res.state.comm.ef_dev
    never = [(t, j) for t in range(M) for j in range(N)
             if j not in sampled[t]]
    assert never, "some device must go unsampled"
    for t, j in never:
        assert not ef[t, j].any()
        assert torch.equal(res.state.theta[t, j],
                           res.state.theta.new_zeros(ef.shape[-1]))
    assert any(ef[t, j].any() for t in range(M) for j in sampled[t])


def test_cohort_bookkeeping_and_eval_cadence(quad_data):
    algo = port_algos()["permfl"]
    res = run(algo, quad_data, rounds=7, seed=6, cohort=COHORT,
              eval_every=3, device_frac=0.5)
    assert len(res.pm_acc) == 3 and len(res.participation) == 7
    assert len(res.cohort_indices) == 7
    for per_round in res.cohort_indices:
        arr = np.asarray(per_round)
        assert arr.shape == (M, COHORT)
        assert (np.diff(arr, axis=1) > 0).all()
        assert arr.min() >= 0 and arr.max() < N
    assert res.participation == [(M, M * round(COHORT * 0.5))] * 7
    every = run(algo, quad_data, rounds=7, seed=6, cohort=COHORT,
                device_frac=0.5)
    assert res.pm_acc == [every.pm_acc[i] for i in (2, 5, 6)]
    assert_states_equal(res.state, every.state)


def test_cohort_never_moves_the_mask_stream(quad_data):
    algo = port_algos()["permfl"]
    runs = {c: run(algo, quad_data, rounds=6, seed=9, team_frac=0.67,
                   cohort=c) for c in (None, 3, 5, N)}
    teams = {c: [t for t, _ in r.participation] for c, r in runs.items()}
    for c in (3, 5, N):
        assert teams[c] == teams[None], c
    assert_bit_equal(runs[None], runs[N])


def test_cohort_validation(quad_data):
    from repro_torch.train.sweep import run_sweep

    algo = port_algos()["permfl"]
    for bad in (0, -1, N + 1):
        with pytest.raises(ValueError, match="cohort"):
            run(algo, quad_data, rounds=1, cohort=bad)
    with pytest.raises(ValueError, match="cohort"):
        run_sweep(algo, [{}], (0,), P0, quad_data, quad_data,
                  metric_fn=neg, rounds=1, m=M, n=N, cohort=N + 1,
                  device="cpu")
    with pytest.raises(ValueError, match="needs cohort"):
        run(algo, quad_data, rounds=1, cohort_indices=lambda t: None)
    with pytest.raises(ValueError, match="expected"):
        run(algo, quad_data, rounds=1, cohort=2,
            cohort_indices=lambda t: [[0, 1, 2]] * M)


def test_sweep_cohort_lanes_equal_solo_runs(quad_data):
    from repro_torch.train.sweep import run_multi_sweep, run_sweep

    algo = port_algos()["permfl"]
    kw = dict(metric_fn=neg, rounds=4, m=M, n=N, device="cpu")
    sw = run_sweep(algo, [{}, dict(lam=0.3)], (0, 5), P0, quad_data,
                   quad_data, cohort=COHORT, **kw)
    assert len(sw) == 4
    _, rebuild = algo.tree_hparams()
    for res, cfg in zip(sw, sw.configs):
        solo = run(rebuild({"lam": cfg["lam"]}), quad_data, rounds=4,
                   seed=cfg["seed"], cohort=COHORT)
        assert res.cohort_indices == solo.cohort_indices
        assert res.pm_acc == solo.pm_acc
        assert_states_equal(res.state, solo.state)
    assert sw[2].pm_acc != sw[0].pm_acc
    # per-config maps injected: the same lanes
    given = run_sweep(algo, [{}, dict(lam=0.3)], (0, 5), P0, quad_data,
                      quad_data, cohort=COHORT, cohort_indices=[
                          lambda t, r=r: r.cohort_indices[t] for r in sw],
                      **kw)
    for a, b in zip(given, sw):
        assert a.cohort_indices == b.cohort_indices
        assert a.pm_acc == b.pm_acc
        assert_states_equal(a.state, b.state)
    multi = run_multi_sweep(
        [dict(algo=algo, params0=P0, cohort=COHORT),
         dict(algo=algo, params0=P0)], quad_data, quad_data, **kw)
    solo_c = run(algo, quad_data, rounds=4, cohort=COHORT)
    solo_s = run(algo, quad_data, rounds=4)
    assert multi[0][0].cohort == COHORT and multi[1][0].cohort is None
    assert multi[0][0].pm_acc == solo_c.pm_acc
    assert multi[0][0].cohort_indices == solo_c.cohort_indices
    assert multi[1][0].pm_acc == solo_s.pm_acc


# ---------------------------------------------------------- bounded eval

def test_chunked_eval_is_bit_equal(small_fed_data):
    """Every eval in chunks of 5 devices (N*M = 12) equals one call over
    all devices, value for value: MCLR tiers of random models."""
    from repro_torch.configs.paper_mclr import CONFIG
    from repro_torch.core.algorithm import eval_global, eval_personal
    from repro_torch.core.permfl import PerMFLState, eval_stacked
    from repro_torch.flat import Layout
    from repro_torch.scenarios.spec import fns_for

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    _, metric = fns_for(CONFIG)
    gen = torch.Generator().manual_seed(0)
    layout = Layout.of({"b": torch.zeros(10), "w": torch.zeros(784, 10)})
    tier = lambda *lead: torch.randn(  # noqa: E731
        lead + (layout.stride,), generator=gen) * 0.01
    st = PerMFLState(x=tier(), w=tier(m), theta=tier(m, n), round=0,
                     layout=layout)
    val = {"x": torch.from_numpy(fd.val_x), "y": torch.from_numpy(fd.val_y)}
    for which in ("pm", "tm", "gm"):
        one = eval_stacked(st, val, metric, which=which)
        assert torch.equal(eval_stacked(st, val, metric, which=which,
                                        chunk=5), one), which
        assert torch.equal(eval_stacked(st, val, metric, which=which,
                                        chunk=1), one), which
    assert torch.equal(eval_global(st.x, layout, val, metric, chunk=5),
                       eval_global(st.x, layout, val, metric))
    assert torch.equal(eval_personal(st.theta, layout, val, metric,
                                     chunk=5),
                       eval_personal(st.theta, layout, val, metric))
    # a sweep's stacked tiers: chunks cross config boundaries
    sx = torch.stack([st.x, st.x * 2])
    sval = {k: v.expand((2,) + tuple(v.shape)) for k, v in val.items()}
    assert torch.equal(eval_global(sx, layout, sval, metric, chunk=7),
                       eval_global(sx, layout, sval, metric))


def test_engine_eval_in_chunks_is_bit_equal(quad_data, monkeypatch):
    import repro_torch.core.algorithm as A

    algo = port_algos()["ditto"]
    whole = run(algo, quad_data, rounds=2, cohort=COHORT)
    monkeypatch.setattr(A, "EVAL_CHUNK", 4)
    chunked = run(algo, quad_data, rounds=2, cohort=COHORT)
    assert_bit_equal(whole, chunked)
    algo = port_algos()["permfl"]
    monkeypatch.setattr(A, "EVAL_CHUNK", 1 << 16)
    whole = run(algo, quad_data, rounds=2)
    monkeypatch.setattr(A, "EVAL_CHUNK", 5)
    assert_bit_equal(whole, run(algo, quad_data, rounds=2))


# ------------------------------------------------- scenarios and the CLI

def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cohort_cells_dump_and_describe_as_the_reference():
    from repro.scenarios.__main__ import main as j_main
    from repro_torch.scenarios.__main__ import main

    for n in (1000, 1000000):
        name = f"cohort/virtual/n{n}"
        rc, got = _cli(main, ["dump", name])
        _, want = _cli(j_main, ["dump", name])
        assert rc == 0 and got == want
        _, got = _cli(main, ["describe", name])
        _, want = _cli(j_main, ["describe", name])
        assert got.replace("repro_torch.", "repro.") == want


def test_cohort_cell_runs_one_round_on_the_cpu():
    from repro_torch.scenarios import run_scenario

    res = run_scenario("cohort/virtual/n1000", rounds=1, device="cpu",
                       time_parts=True)
    assert (res.cohort, res.population) == (64, 1000)
    assert np.asarray(res.cohort_indices).shape == (1, 2, 64)
    assert res.participation == [(2, 128)]
    assert set(res.part_seconds) == {"sample", "gather", "round",
                                     "scatter", "eval"}
    assert set(res.setup_seconds) == {"data", "to_device"}
    assert all(0.0 <= a <= 1.0 for a in res.pm_acc + res.gm_acc)
    theta = res.state.theta
    assert theta.shape[:2] == (2, 1000)
    touched = theta.abs().sum(-1) > 0
    for t in range(2):
        want = torch.zeros(1000, dtype=torch.bool)
        want[res.cohort_indices[0][t]] = True
        assert torch.equal(touched[t], want)
    # cohort=None runs the stacked path on the same cell
    full = run_scenario("cohort/virtual/n1000", rounds=1, device="cpu",
                        cohort=None)
    assert full.cohort is None and full.participation == [(2, 2000)]


def test_cli_run_with_cohort_and_system_json(tmp_path, monkeypatch):
    """The footer carries the timeline; the event log's header the cohort
    and population; the run the CLI made its participation."""
    import repro_torch.scenarios as scenarios
    from repro_torch.obs.events import read_jsonl
    from repro_torch.scenarios.__main__ import main

    runs = []
    run = scenarios.run_scenario
    monkeypatch.setattr(scenarios, "run_scenario",
                        lambda *a, **k: runs.append(run(*a, **k)) or runs[-1])
    rc, out = _cli(main, ["run", "table1/mnist/mclr/permfl", "--smoke",
                          "--cohort", "2", "--system", "wan-cellular",
                          "--deadline", "30", "--device", "cpu",
                          "--trace-dir", str(tmp_path / "c2"), "--json"])
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    header = read_jsonl(rec["events_path"])[0]
    assert header["cohort"] == 2 and header["population"] == 3
    assert rec["timeline"]["profile"] == "wan-cellular"
    assert rec["timeline"]["rounds"] == 2
    assert runs[-1].participation[-1] == (2, 4)
    rc, out = _cli(main, ["run", "table1/mnist/mclr/permfl", "--smoke",
                          "--cohort", "0", "--device", "cpu",
                          "--trace-dir", str(tmp_path / "c0"), "--json"])
    assert rc == 0
    assert "cohort" not in read_jsonl(json.loads(out)["events_path"])[0]
