"""The port's compressed uplinks against the JAX package: configs, plans,
the byte ledger, scenarios, and compressed PerMFL rounds on the MCLR
model (``small_fed_data``, k_team=2, l_local=2; 1 and 3 rounds; full and
masked participation) with the reference's uniforms injected.

Rounds are held at the tolerances of the uncompressed suite. Top-k, int8
and sign make discrete choices on the message (which values to keep, a
floor, a sign), and device gradients that differ by ~1e-7 between XLA
and PyTorch can put a message on the other side of a boundary. So both
runs record every uplink's messages, and :class:`Flips` replays the
choices on both: a choice that differs where the two messages still
agree must lie within ``WINDOW`` of its boundary in the reference, and
only the columns of such flips (and what they carried into later
uplinks) may fall outside the tolerance, each by at most two of that
compressor's steps. Rand-k chooses on the injected uniforms alone and
identity chooses nothing, so neither is excused anything.
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.comm import CommConfig as JCommConfig  # noqa: E402
from repro.comm import ledger as JL  # noqa: E402
from repro.configs.paper_cnn import CONFIG as J_CNN  # noqa: E402
from repro.configs.paper_mclr import CONFIG as J_MCLR  # noqa: E402
from repro.core import permfl as JP  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPRESSORS = ["identity", "topk", "randk", "int8", "sign"]
TOL_1 = dict(rtol=1e-4, atol=1e-5)
TOL_3 = dict(rtol=1e-4, atol=1e-4)
# a flipped choice must lie this close to its boundary in the reference
# (in the message's units; the messages differ by ~1e-7)
WINDOW = 1e-6
# leading (sender) axes of each tier
LEAD = {"x": 0, "w": 1, "theta": 2, "ef_dev": 2, "ef_team": 1}
TEAM_MASK = np.array([1, 0, 1, 1], np.float32)
DEVICE_MASK = np.array([[1, 0, 1], [1, 1, 1], [0, 0, 0], [1, 1, 0]],
                       np.float32)
J_CFG = {"mclr": J_MCLR, "cnn": J_CNN}


@functools.lru_cache(maxsize=None)
def jax_fns(kind):
    """One loss closure per model: JAX's jitted round caches on it."""
    cfg = J_CFG[kind]
    return lambda p, b: JPM.loss_fn(p, cfg, b)


@functools.lru_cache(maxsize=None)
def jax_fns_recorded(kind):
    """The loss closure of recorded rounds: its own jit cache entries,
    all traced with the recording uplink of :func:`recording`."""
    cfg = J_CFG[kind]
    return lambda p, b: JPM.loss_fn(p, cfg, b)


@functools.lru_cache(maxsize=None)
def jax_init(kind):
    return JPM.init_params(jax.random.PRNGKey(1), J_CFG[kind])


def port_loss(kind):
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    from repro_torch.scenarios.spec import fns_for
    return fns_for({"mclr": MCLR, "cnn": CNN}[kind])[0]


@functools.lru_cache(maxsize=None)
def _uniform_fn(b, sizes):
    def draw(key):
        return jnp.concatenate([
            jax.vmap(lambda q, p=p: jax.random.uniform(q, (p,)))(
                jax.random.split(jax.random.fold_in(key, i), b))
            for i, p in enumerate(sizes)], axis=1)
    return jax.jit(draw)


def reference_uniforms(seed, sizes):
    """``uniforms(t, k, b)`` giving the port the reference's streams: the
    round key ``fold_in(PRNGKey(seed), t)``, the uplink key
    ``fold_in(round_key, k)``, per leaf i ``split(fold_in(key, i), b)``
    and one ``uniform(key, (p,))`` per sender, leaves back to back."""
    base = jax.random.PRNGKey(seed)

    def src(t, k, b):
        key = jax.random.fold_in(jax.random.fold_in(base, t), k)
        return np.array(_uniform_fn(b, tuple(sizes))(key))
    return src


# ------------------------------------------- recorded uplinks, flips

# where the recording uplinks append: {"ref": [msg], "port": [(msg, u)]}
_SINK = {}


def _record_ref(msg):
    _SINK["ref"].append(np.array(msg))


def _ref_uplink(cfg, key, delta, ef, batch_shape):
    """The reference's ``compress_tree_ef`` that also hands its messages
    (delta + ef, leaves back to back per sender) to the host."""
    b = int(np.prod(batch_shape))
    msg = jnp.concatenate([(d + e).reshape(b, -1) for d, e in zip(
        jax.tree.leaves(delta), jax.tree.leaves(ef))], axis=1)
    jax.debug.callback(_record_ref, msg, ordered=True)
    return _REF_UPLINK(cfg, key, delta, ef, batch_shape)


def _ref_uplink_plain(cfg, key, msg, batch_shape):
    """The reference's ``compress_tree`` (no error feedback), recording
    its messages as :func:`_ref_uplink` does."""
    b = int(np.prod(batch_shape))
    flat = jnp.concatenate([m.reshape(b, -1) for m in jax.tree.leaves(msg)],
                           axis=1)
    jax.debug.callback(_record_ref, flat, ordered=True)
    return _REF_PLAIN(cfg, key, msg, batch_shape)


def _record_port(msg, u, p):
    _SINK["port"].append((
        msg[:, :p].detach().numpy().copy(),
        None if u is None else u[:, :p].detach().numpy().copy()))


def _port_uplink(cfg, layout, delta, ef, u=None, **kw):
    _record_port(delta + ef, u, layout.size)
    return _PORT_UPLINK(cfg, layout, delta, ef, u, **kw)


def _port_uplink_plain(cfg, layout, msg, u=None, **kw):
    _record_port(msg, u, layout.size)
    return _PORT_PLAIN(cfg, layout, msg, u, **kw)


_REF_UPLINK, _REF_PLAIN = JP.compress_tree_ef, JP.compress_tree
_PORT_UPLINK = _PORT_PLAIN = None


@contextlib.contextmanager
def recording():
    """Both rounds' uplinks, with error feedback and without, record their
    messages into the yielded sink (run the reference with
    ``jax_fns_recorded`` inside)."""
    global _PORT_UPLINK, _PORT_PLAIN
    from repro_torch.core import permfl as P

    _PORT_UPLINK, _PORT_PLAIN = P.compress_flat_ef, P.compress_flat
    _SINK.update(ref=[], port=[])
    JP.compress_tree_ef, P.compress_flat_ef = _ref_uplink, _port_uplink
    JP.compress_tree, P.compress_flat = _ref_uplink_plain, _port_uplink_plain
    try:
        yield _SINK
    finally:
        JP.compress_tree_ef, P.compress_flat_ef = _REF_UPLINK, _PORT_UPLINK
        JP.compress_tree, P.compress_flat = _REF_PLAIN, _PORT_PLAIN


def _choices(name, m, u, k):
    """One leaf's messages m (B, p) -> (the compressor's choice per value,
    each value's distance to its boundary, the compressor's step, and
    for int8 each value's row scale)."""
    if name == "topk":
        a = np.abs(m)
        thr = np.partition(a, a.shape[1] - k, axis=1)[:, -k][:, None]
        strict, tie = a > thr, a == thr
        cap = k - strict.sum(1, keepdims=True)
        return (strict | (tie & (np.cumsum(tie, 1) <= cap)),
                np.abs(a - thr), float(thr.max()), None)
    if name == "int8":
        b, p = m.shape
        rows = -(-p // 128)
        pad = np.zeros((b, rows * 128), np.float32)
        pad[:, :p] = np.abs(m)
        scale = np.maximum(pad.reshape(b, rows, 128).max(2)
                           * np.float32(1 / 127), np.float32(1e-12))
        s = np.repeat(scale, 128, axis=1)[:, :p]
        v = m / s + u
        return (np.clip(np.floor(v), -127, 127), np.abs(v - np.round(v)) * s,
                float(scale.max()), s)
    assert name == "sign", name
    return np.sign(m), np.abs(m), float(np.abs(m).mean(1).max()), None


class Flips:
    """The compressor's choices replayed on both runs' recorded uplinks,
    in order. ``columns``: per leaf, the columns where a choice differed
    in some uplink (for any sender); ``first``/``carried``: flips at a
    column for the first time (each checked to lie within WINDOW of the
    boundary in the reference) and at a column already flipped earlier;
    ``step``: the compressor's largest step in the run (top-k's
    threshold, int8's scale, sign's scale).

    An int8 row's values share a scale, the absmax of the row. Where a
    flip earlier left a row's absmax different in the two runs, the
    scale moves every value of the row: such a row (checked to hold an
    earlier flip) joins ``columns`` whole, and its flips are carried."""

    def __init__(self, name, sink, sizes, k_frac):
        from repro_torch.comm import leaf_k

        ref, port = sink["ref"], sink["port"]
        assert len(ref) == len(port) > 0, (len(ref), len(port))
        self.columns = [np.zeros(p, bool) for p in sizes]
        self.first = self.carried = 0
        self.step = 0.0
        if name not in ("topk", "int8", "sign"):
            return
        offs = np.cumsum((0,) + tuple(sizes))
        for mr, (mp, u) in zip(ref, port):
            assert mr.shape == mp.shape, (mr.shape, mp.shape)
            for i, p in enumerate(sizes):
                cols = slice(offs[i], offs[i] + p)
                k = leaf_k(k_frac, p)
                uu = None if u is None else u[:, cols]
                cr, dist, step, sr = _choices(name, mr[:, cols], uu, k)
                cp, _, _, sp = _choices(name, mp[:, cols], uu, k)
                seen = self.columns[i][None]
                flip = cr != cp
                if name == "int8":
                    moved = np.abs(sr - sp) > WINDOW / 127
                    row = np.arange(p) // 128
                    had = np.bincount(row, self.columns[i], row[-1] + 1)
                    assert not (moved & ~(had[row] > 0)).any(), (
                        f"int8 leaf {i}: a row scale moved with no flip "
                        "before it")
                    seen = seen | moved
                    flip = flip | moved
                new = (cr != cp) & ~seen
                assert (dist[new] <= WINDOW).all(), (
                    f"{name} leaf {i}: a choice flipped "
                    f"{dist[new].max():.3g} from its boundary")
                self.first += int(new.sum())
                self.carried += int(((cr != cp) & seen).sum())
                self.columns[i] |= flip.any(0)
                self.step = max(self.step, step)

    def __repr__(self):
        return (f"Flips(first={self.first}, carried={self.carried}, "
                f"columns={sum(int(c.sum()) for c in self.columns)}, "
                f"step={self.step:.3g})")


def run_jax(kind, js, train, rounds, jcfg, masks, recorded=True):
    """``rounds`` reference rounds from ``js`` (recorded: inside
    :func:`recording`, with the recorded loss closure)."""
    fn = (jax_fns_recorded if recorded else jax_fns)(kind)
    tm, dm = masks if masks is not None else (None, None)
    jhp = JP.PerMFLHParams(k_team=2, l_local=2)
    jtrain = jax.tree.map(jnp.asarray, train)
    m, n = jax.tree.leaves(js.theta)[0].shape[:2]
    for _ in range(rounds):
        js = JP.permfl_round(js, jtrain, jhp, fn, m_teams=m, n_devices=n,
                             team_mask=tm, device_mask=dm, comm=jcfg)
    jax.effects_barrier()
    return js


def run_port(kind, state, train, rounds, cfg, masks):
    """``rounds`` port rounds from ``state`` with the reference's
    uniforms injected."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import permfl as P

    tm, dm = masks if masks is not None else (None, None)
    hp = P.PerMFLHParams(k_team=2, l_local=2)
    src = reference_uniforms(cfg.seed, state.layout.leaf_sizes)
    ttrain = params_from_numpy(train)
    m, n = state.theta.shape[:2]
    for _ in range(rounds):
        state = P.permfl_round(
            state, ttrain, hp, port_loss(kind), m_teams=m, n_devices=n,
            team_mask=None if tm is None else torch.from_numpy(tm),
            device_mask=None if dm is None else torch.from_numpy(dm),
            comm=cfg, uniforms=src)
    return state


def run_both(kind, fd, rounds, compressor, masks, k_frac=0.1,
             error_feedback=True):
    """``rounds`` compressed rounds of both implementations from the JAX
    init, recorded; returns (port state, JAX state, Flips)."""
    from repro_torch.comm import CommConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import permfl as P

    m, n = fd.m_teams, fd.n_devices
    train = {"x": fd.train_x, "y": fd.train_y}
    jcfg = JCommConfig(compressor, k_frac=k_frac,
                       error_feedback=error_feedback)
    cfg = CommConfig(compressor, k_frac=k_frac,
                     error_feedback=error_feedback)
    state = P.init_state(params_from_numpy(jax_init(kind)), m, n, comm=cfg)
    with recording() as sink:
        js = run_jax(kind, JP.init_state(jax_init(kind), m, n, comm=jcfg),
                     train, rounds, jcfg, masks)
        state = run_port(kind, state, train, rounds, cfg, masks)
    flips = Flips(compressor, sink, state.layout.leaf_sizes, k_frac)
    return state, js, flips


def assert_state_close(state, jstate, tol, flips):
    """Tiers and residuals of the port's state against the JAX state: all
    coordinates within ``tol``, except in the columns of ``flips``, and
    there by at most two of the compressor's steps (see the module
    docstring)."""
    from repro_torch.convert import to_numpy

    got = to_numpy(state)
    pairs = [(t, got[t], getattr(jstate, t)) for t in ("x", "w", "theta")]
    pairs += [(t, got["comm"][t], getattr(jstate.comm, t))
              for t in ("ef_dev", "ef_team")]
    for tier, g, w in pairs:
        assert len(flips.columns) == len(jax.tree.leaves(g))
        gl, wl = jax.tree.leaves(g), [np.asarray(v) for v in
                                      jax.tree.leaves(w)]
        for i, (a, b) in enumerate(zip(gl, wl)):
            bad = ~np.isclose(a, b, **tol)
            cols = flips.columns[i].reshape(a.shape[LEAD[tier]:])
            assert not (bad & ~cols).any(), (
                f"{tier} leaf {i}: {int((bad & ~cols).sum())} coordinates "
                f"outside {tol} where no choice flipped ({flips})")
            off = np.abs(a - b)[bad]
            assert (off <= 2 * flips.step + tol["atol"]).all(), (
                f"{tier} leaf {i}: a flipped coordinate {off.max():.3g} off "
                f"({flips})")


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masks"])
@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_mclr_rounds_match_jax(small_fed_data, compressor, rounds, masked):
    masks = (TEAM_MASK, DEVICE_MASK) if masked else None
    state, jstate, flips = run_both("mclr", small_fed_data, rounds,
                                    compressor, masks)
    assert state.round == int(jstate.round) == rounds
    assert_state_close(state, jstate, TOL_1 if rounds == 1 else TOL_3, flips)


# --------------------------------------------------- round semantics

def _mclr_state(fd, comm=None):
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import permfl as P

    return P.init_state(params_from_numpy(jax_init("mclr")), fd.m_teams,
                        fd.n_devices, comm=comm)


def _round(fd, state, comm, **kw):
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import permfl as P

    return P.permfl_round(
        state, params_from_numpy({"x": fd.train_x, "y": fd.train_y}),
        P.PerMFLHParams(k_team=2, l_local=2), port_loss("mclr"),
        m_teams=fd.m_teams, n_devices=fd.n_devices, comm=comm, **kw)


def test_identity_round_matches_the_uncompressed_round(small_fed_data):
    """Identity under error feedback ships delta + 0: the same tiers as
    the uncompressed round, and no residual."""
    from repro_torch.comm import CommConfig

    cfg = CommConfig("identity")
    plain, comp = _mclr_state(small_fed_data), _mclr_state(small_fed_data,
                                                           cfg)
    for _ in range(3):
        plain = _round(small_fed_data, plain, None)
        comp = _round(small_fed_data, comp, cfg)
    for tier in ("x", "w", "theta"):
        torch.testing.assert_close(getattr(comp, tier), getattr(plain, tier),
                                   rtol=0, atol=1e-6)
    assert float(comp.comm.ef_dev.abs().max()) == 0.0
    assert float(comp.comm.ef_team.abs().max()) == 0.0


def test_nonparticipating_senders_keep_their_residuals(small_fed_data):
    from repro_torch.comm import CommConfig

    cfg = CommConfig("topk", k_frac=0.2)
    tm = torch.tensor([1.0, 0.0, 1.0, 1.0])
    dm = torch.ones(4, 3) * tm[:, None]
    st = _round(small_fed_data, _mclr_state(small_fed_data, cfg), cfg,
                team_mask=tm, device_mask=dm)
    assert float(st.comm.ef_team[1].abs().max()) == 0.0
    assert float(st.comm.ef_dev[1].abs().max()) == 0.0
    assert float(st.comm.ef_team[0].abs().max()) > 0.0


def test_masked_out_teams_devices_do_not_transmit(small_fed_data):
    """team_mask with device_mask=None: devices of a masked-out team run
    but never transmit, so their residuals stay zero."""
    from repro_torch.comm import CommConfig

    cfg = CommConfig("int8")
    st = _round(small_fed_data, _mclr_state(small_fed_data, cfg), cfg,
                team_mask=torch.tensor([1.0, 0.0, 1.0, 1.0]))
    assert float(st.comm.ef_dev[1].abs().max()) == 0.0
    assert float(st.comm.ef_dev[0].abs().max()) > 0.0


def test_round_needs_a_comm_state(small_fed_data):
    from repro_torch.comm import CommConfig

    with pytest.raises(ValueError, match="CommState"):
        _round(small_fed_data, _mclr_state(small_fed_data),
               CommConfig("topk"))


def test_round_leaves_its_input_state_and_generator_alone(small_fed_data):
    """Two rounds from one state draw the same uniforms (the round draws
    from a copy of the generator) and give the same state."""
    from repro_torch.comm import CommConfig

    cfg = CommConfig("randk")
    s0 = _mclr_state(small_fed_data, cfg)
    gen_state = s0.comm.gen.get_state()
    a, b = _round(small_fed_data, s0, cfg), _round(small_fed_data, s0, cfg)
    assert torch.equal(s0.comm.gen.get_state(), gen_state)
    assert float(s0.comm.ef_dev.abs().max()) == 0.0
    for tier in ("x", "w", "theta"):
        assert torch.equal(getattr(a, tier), getattr(b, tier))
    assert torch.equal(a.comm.ef_dev, b.comm.ef_dev)
    assert not torch.equal(a.comm.gen.get_state(), gen_state)


def test_lossy_compressor_without_error_feedback_raises(small_fed_data):
    """Once refused; now every lossy compressor without error feedback
    builds a ``PerMFL`` and rounds through it: finite tiers, residuals
    left at zero, and one compress call per uplink (K LAN + 1 WAN) with
    no error-feedback call. Only a config no compressor knows raises."""
    from repro_torch.comm import CommConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.core import permfl as P

    fd = small_fed_data
    train = params_from_numpy({"x": fd.train_x, "y": fd.train_y})
    calls = []
    plain, with_ef = P.compress_flat, P.compress_flat_ef
    P.compress_flat = lambda *a, **k: calls.append("plain") or plain(*a, **k)
    P.compress_flat_ef = lambda *a, **k: calls.append("ef") \
        or with_ef(*a, **k)
    try:
        for name in ("topk", "randk", "int8", "sign"):
            calls.clear()
            cfg = CommConfig(name, error_feedback=False)
            algo = PerMFL(port_loss("mclr"),
                          PerMFLHParams(k_team=2, l_local=2), comm=cfg)
            state = algo.init_state(params_from_numpy(jax_init("mclr")),
                                    fd.m_teams, fd.n_devices)
            new = algo.round(state, train, team_mask=torch.ones(4),
                             device_mask=torch.ones(4, 3))
            assert calls == ["plain"] * 3, (name, calls)
            assert new.round == 1 and torch.isfinite(new.theta).all()
            assert not torch.equal(new.x, state.x)
            assert float(new.comm.ef_dev.abs().max()) == 0.0
            assert float(new.comm.ef_team.abs().max()) == 0.0
    finally:
        P.compress_flat, P.compress_flat_ef = plain, with_ef
    with pytest.raises(ValueError, match="unknown compressor"):
        CommConfig("gzip", error_feedback=False)


def test_converted_jax_comm_state_continues(small_fed_data):
    """A JAX state with residuals, carried over by ``state_from_numpy``,
    round-trips through ``to_numpy`` exactly, and one more round of each
    implementation from it agrees."""
    from repro_torch.comm import CommConfig
    from repro_torch.convert import state_from_numpy, to_numpy

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    jcfg, cfg = JCommConfig("int8"), CommConfig("int8")
    train = {"x": fd.train_x, "y": fd.train_y}
    js = run_jax("mclr", JP.init_state(jax_init("mclr"), m, n, comm=jcfg),
                 train, 1, jcfg, None, recorded=False)
    as_np = {k: jax.tree.map(np.asarray, getattr(js, k))
             for k in ("x", "w", "theta")}
    as_np["comm"] = {k: jax.tree.map(np.asarray, getattr(js.comm, k))
                     for k in ("ef_dev", "ef_team")}
    state = state_from_numpy({**as_np, "round": int(js.round)})
    back = to_numpy(state)
    for tier in ("x", "w", "theta"):
        jax.tree.map(np.testing.assert_array_equal, back[tier], as_np[tier])
    for tier in ("ef_dev", "ef_team"):
        jax.tree.map(np.testing.assert_array_equal, back["comm"][tier],
                     as_np["comm"][tier])
    with recording() as sink:
        jnext = run_jax("mclr", js, train, 1, jcfg, None)
        nxt = run_port("mclr", state, train, 1, cfg, None)
    assert nxt.round == 2
    assert_state_close(nxt, jnext, TOL_1,
                       Flips("int8", sink, state.layout.leaf_sizes, 0.1))


# --------------------------------------------- configs, plans, ledger

def test_comm_config_matches_the_reference():
    from repro_torch.comm import COMPRESSORS as PORT, CommConfig
    from repro.comm.config import COMPRESSORS as REF

    assert PORT == REF
    for kw in ({}, {"compressor": "topk", "k_frac": 0.25},
               {"compressor": "int8", "error_feedback": False, "seed": 3}):
        assert dataclasses.asdict(CommConfig(**kw)) == \
            dataclasses.asdict(JCommConfig(**kw))
    for bad in ({"compressor": "gzip"}, {"k_frac": 0.0}, {"k_frac": 1.5}):
        with pytest.raises(ValueError):
            CommConfig(**bad)
    assert hash(CommConfig("topk")) == hash(CommConfig("topk"))


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_leaf_plans_match_the_reference(compressor):
    from repro.comm import compression_plan as jplan
    from repro_torch.comm import CommConfig, compression_plan

    sizes = (1, 10, 127, 128, 129, 4608, 200704)
    for k_frac in (0.01, 0.1, 0.25, 1.0):
        got = compression_plan(CommConfig(compressor, k_frac=k_frac), sizes)
        want = jplan(JCommConfig(compressor, k_frac=k_frac), sizes)
        assert [dataclasses.astuple(g) for g in got] == \
            [dataclasses.astuple(w) for w in want]


# the leaf sizes tests/test_comm_bytes.py draws from (1..5000), swept
LEAF_SIZES = sorted({1, 2, 7, 8, 9, 127, 128, 129, 255, 256, 257, 1000,
                     1023, 4097, 5000} | set(range(1, 5001, 97)))
K_FRACS = (0.01, 0.1, 0.25, 0.5, 1.0)


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_ledger_bytes_match_the_reference(compressor):
    from repro_torch.comm import (CommConfig, compressed_leaf_bytes,
                                  full_leaf_bytes, model_bytes)

    for k_frac in K_FRACS:
        cfg = CommConfig(compressor, k_frac=k_frac)
        jcfg = JCommConfig(compressor, k_frac=k_frac)
        for p in LEAF_SIZES:
            assert compressed_leaf_bytes(cfg, p) == \
                JL.compressed_leaf_bytes(jcfg, p), (k_frac, p)
            assert full_leaf_bytes(p) == JL.full_leaf_bytes(p)
        assert model_bytes(LEAF_SIZES, cfg) == \
            JL.model_bytes(LEAF_SIZES, jcfg)


@pytest.mark.parametrize("compressor", ["topk", "int8", "sign"])
def test_ledger_rounds_match_the_reference(compressor):
    """CommLedger over the paper CNN's leaves: per-round bytes, totals,
    gated device counts, summary and the uncompressed baseline, as the
    reference's."""
    from repro_torch.comm import CommConfig, CommLedger
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params

    layout = Layout.of(init_params(CNN, torch.Generator().manual_seed(0)))
    led = CommLedger.for_layout(CommConfig(compressor), layout)
    jled = JL.CommLedger.for_params(JCommConfig(compressor), jax_init("cnn"))
    assert led.leaf_sizes == jled.leaf_sizes
    gated = int((DEVICE_MASK * TEAM_MASK[:, None]).sum())
    for ledger in (led, jled):
        ledger.log_round(k_team=5, n_teams=4, n_devices=40)
        ledger.log_round(k_team=5, n_teams=int(TEAM_MASK.sum()),
                         n_devices=gated)
    assert [dataclasses.astuple(r) for r in led.rounds] == \
        [dataclasses.astuple(r) for r in jled.rounds]
    assert led.summary() == jled.summary()
    assert led.total_bytes() == jled.total_bytes()


@pytest.mark.parametrize("compressor", ["topk", "int8"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_ledger_log_round_masks_matches_the_reference(compressor, as_tensor):
    """log_round_masks from raw masks (devices of masked-out teams gated)
    as the reference's; equal to log_round with the counts the engine
    gates itself."""
    from repro_torch.comm import CommConfig, CommLedger
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params

    layout = Layout.of(init_params(CNN, torch.Generator().manual_seed(0)))
    led = CommLedger.for_layout(CommConfig(compressor), layout)
    counted = CommLedger.for_layout(CommConfig(compressor), layout)
    jled = JL.CommLedger.for_params(JCommConfig(compressor), jax_init("cnn"))
    ones_t, ones_d = np.ones_like(TEAM_MASK), np.ones_like(DEVICE_MASK)
    for tm, dm in ((TEAM_MASK, DEVICE_MASK), (ones_t, ones_d),
                   (TEAM_MASK, ones_d)):
        given = ((torch.from_numpy(np.asarray(tm)),
                  torch.from_numpy(np.asarray(dm)))
                 if as_tensor else (tm, dm))
        led.log_round_masks(k_team=5, team_mask=given[0],
                            device_mask=given[1])
        jled.log_round_masks(k_team=5, team_mask=tm, device_mask=dm)
        counted.log_round(k_team=5, n_teams=int(np.sum(tm)),
                          n_devices=int((np.asarray(dm)
                                         * np.asarray(tm)[:, None]).sum()))
    assert [dataclasses.astuple(r) for r in led.rounds] == \
        [dataclasses.astuple(r) for r in jled.rounds] == \
        [dataclasses.astuple(r) for r in counted.rounds]
    assert led.summary() == jled.summary()


# ------------------------------------------- scenarios, engine, CLI

COMM_CELLS = ["comm/mnist/mclr/" + c for c in (
    "uncompressed", "identity", "topk_10", "topk_25", "randk_10", "int8",
    "sign")]


@pytest.mark.parametrize("name", COMM_CELLS)
def test_comm_cells_equal_the_reference(name):
    from repro.scenarios import SCENARIOS as J_SCENARIOS
    from repro_torch.scenarios import FLScenario, get_scenario

    s, js = get_scenario(name), J_SCENARIOS[name]
    assert s.to_dict() == js.to_dict()
    assert s.spec_hash() == js.spec_hash()
    assert FLScenario.from_dict(js.to_dict()) == s
    cnn = dataclasses.replace(get_scenario("fig2/fmnist/cnn/permfl"),
                              comm=s.comm)
    jcnn = dataclasses.replace(J_SCENARIOS["fig2/fmnist/cnn/permfl"],
                               comm=js.comm)
    assert cnn.spec_hash() == jcnn.spec_hash()


def test_run_permfl_comm_matches_the_reference(small_fed_data):
    """The engine with top-k uplinks: the ledger equals the reference
    run's byte for byte, and the metrics agree."""
    from repro.train.fl_trainer import run_permfl as j_run
    from repro_torch.comm import CommConfig
    from repro_torch.core.permfl import PerMFLHParams
    from repro_torch.scenarios.spec import fns_for
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    from repro_torch.train.fl_trainer import run_permfl

    fd = small_fed_data
    tr = {"x": fd.train_x, "y": fd.train_y}
    va = {"x": fd.val_x, "y": fd.val_y}
    kw = dict(rounds=2, m=fd.m_teams, n=fd.n_devices)
    jres = j_run(jax_init("mclr"), jax.tree.map(jnp.asarray, tr),
                 jax.tree.map(jnp.asarray, va), loss_fn=jax_fns("mclr"),
                 metric_fn=lambda p, b: JPM.accuracy(p, J_MCLR, b),
                 hp=JP.PerMFLHParams(k_team=2, l_local=2),
                 comm=JCommConfig("topk", k_frac=0.1), **kw)
    loss, met = fns_for(MCLR)
    res = run_permfl(jax.tree.map(np.asarray, jax_init("mclr")), tr, va,
                     loss_fn=loss, metric_fn=met,
                     hp=PerMFLHParams(k_team=2, l_local=2),
                     comm=CommConfig("topk", k_frac=0.1), device="cpu", **kw)
    assert res.comm.summary() == jres.comm.summary()
    assert [dataclasses.astuple(r) for r in res.comm.rounds] == \
        [dataclasses.astuple(r) for r in jres.comm.rounds]
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-4)
    one = 1.0 / fd.val_y.shape[-1]
    np.testing.assert_allclose(res.pm_acc, jres.pm_acc, atol=one + 1e-6)


def test_run_scenario_comm_cell_on_cpu():
    """A comm cell at a small size through run_scenario with the port's
    own generator: finite metrics and the ledger of the byte model."""
    from repro_torch.comm import compressed_leaf_bytes, full_leaf_bytes
    from repro_torch.scenarios import get_scenario, run_scenario

    s = get_scenario("comm/mnist/mclr/int8").scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 2})
    res = run_scenario(s, rounds=2, device="cpu")
    assert all(np.isfinite(res.pm_acc + res.train_loss))
    sizes = res.state.layout.leaf_sizes
    comp = sum(compressed_leaf_bytes(s.comm, p) for p in sizes)
    full = sum(full_leaf_bytes(p) for p in sizes)
    assert res.comm.total_bytes() == 2 * (2 * (comp + full)
                                          + 2 * 6 * (comp + full))
    assert res.state.comm is not None


def test_cli_runs_a_comm_cell_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "run",
         "comm/mnist/mclr/topk_10", "--rounds", "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr
    assert "comm/mnist/mclr/topk_10: rounds=1" in out.stdout
    assert " MB total (wan_up " in out.stdout
