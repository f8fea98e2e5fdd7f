"""The port's PerMFL round against ``repro.core.permfl.permfl_round`` on
the shared fixtures: mclr and cnn on ``small_fed_data``, dnn on
``tabular_fed_data``, with k_team=2, l_local=2; 1 and 3 rounds; full
participation and injected masks (a participating team with no devices,
which takes the masked-mean fallback, and a masked-out team); the
momentum and weight-decay branches; and eval_stacked's PM/TM/GM
matrices. The JAX round runs its prox step through the XLA reference,
as the JAX suite does on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs.paper_cnn import CONFIG as J_CNN  # noqa: E402
from repro.configs.paper_dnn import CONFIG as J_DNN  # noqa: E402
from repro.configs.paper_mclr import CONFIG as J_MCLR  # noqa: E402
from repro.core import permfl as JP  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402

# one round, and three: XLA's and torch's CPU matmuls sum in different
# orders, and the gap grows with the rounds
TOL_1 = dict(rtol=1e-4, atol=1e-5)
TOL_3 = dict(rtol=1e-4, atol=1e-4)

J_CFG = {"mclr": J_MCLR, "dnn": J_DNN, "cnn": J_CNN}

# injected participation: team 1 masked out; team 2 participates with no
# devices (its team mean falls back to w); teams 0, 3 partial
TEAM_MASK = np.array([1, 0, 1, 1], np.float32)
DEVICE_MASK = np.array([[1, 0, 1], [1, 1, 1], [0, 0, 0], [1, 1, 0]],
                       np.float32)


@functools.lru_cache(maxsize=None)
def _jax_fns(kind):
    """One loss/metric closure per model: JAX's jitted round caches on
    the loss function's identity."""
    cfg = J_CFG[kind]
    return (lambda p, b: JPM.loss_fn(p, cfg, b),
            lambda p, b: JPM.accuracy(p, cfg, b))


@functools.lru_cache(maxsize=None)
def _jax_init(kind):
    return JPM.init_params(jax.random.PRNGKey(1), J_CFG[kind])


def _port_fns(kind):
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.paper_dnn import CONFIG as DNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    from repro_torch.scenarios.spec import fns_for
    return fns_for({"mclr": MCLR, "dnn": DNN, "cnn": CNN}[kind])


def _data(fd):
    """(numpy train, numpy val) batches of a FederatedData."""
    return ({"x": fd.train_x, "y": fd.train_y},
            {"x": fd.val_x, "y": fd.val_y})


def _assert_state_close(port_state, jax_state, tol):
    from repro_torch.convert import to_numpy

    got = to_numpy(port_state)
    for tier in ("x", "w", "theta"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), err_msg=tier, **tol),
            got[tier], getattr(jax_state, tier))


def _run_both(kind, fd, rounds, hp_kw, masks):
    """`rounds` rounds of both implementations from the JAX init."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import permfl as P

    m, n = fd.m_teams, fd.n_devices
    train, _ = _data(fd)
    tm, dm = masks if masks is not None else (None, None)
    jhp = JP.PerMFLHParams(k_team=2, l_local=2, **hp_kw)
    jstate = JP.init_state(_jax_init(kind), m, n)
    jtrain = jax.tree.map(jnp.asarray, train)
    for _ in range(rounds):
        jstate = JP.permfl_round(jstate, jtrain, jhp, _jax_fns(kind)[0],
                                 m_teams=m, n_devices=n, team_mask=tm,
                                 device_mask=dm)
    hp = P.PerMFLHParams(k_team=2, l_local=2, **hp_kw)
    state = P.init_state(params_from_numpy(_jax_init(kind)), m, n)
    ttrain = params_from_numpy(train)
    for _ in range(rounds):
        state = P.permfl_round(state, ttrain, hp, _port_fns(kind)[0],
                               m_teams=m, n_devices=n,
                               team_mask=None if tm is None
                               else torch.from_numpy(tm),
                               device_mask=None if dm is None
                               else torch.from_numpy(dm))
    return state, jstate


@pytest.fixture(scope="module")
def cnn_masked_round(small_fed_data):
    """(port state, JAX state) after one masked CNN round."""
    return _run_both("cnn", small_fed_data, 1, {}, (TEAM_MASK, DEVICE_MASK))


CASES = [
    ("mclr", "small_fed_data"),
    ("cnn", "small_fed_data"),
    ("dnn", "tabular_fed_data"),
]


@pytest.mark.parametrize("kind,fixture", CASES)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masks"])
def test_one_round_matches_jax(request, kind, fixture, masked):
    if kind == "cnn" and masked:
        state, jstate = request.getfixturevalue("cnn_masked_round")
    else:
        masks = (TEAM_MASK, DEVICE_MASK) if masked else None
        state, jstate = _run_both(kind, request.getfixturevalue(fixture), 1,
                                  {}, masks)
    assert state.round == int(jstate.round) == 1
    _assert_state_close(state, jstate, TOL_1)


@pytest.mark.parametrize("kind,fixture", CASES)
def test_three_rounds_match_jax(request, kind, fixture):
    fd = request.getfixturevalue(fixture)
    state, jstate = _run_both(kind, fd, 3, {}, (TEAM_MASK, DEVICE_MASK))
    _assert_state_close(state, jstate, TOL_3)


@pytest.mark.parametrize("momentum,wd", [(0.9, 0.0), (0.9, 0.01),
                                         (0.0, 0.01)])
def test_momentum_and_weight_decay_branches_match_jax(small_fed_data,
                                                       momentum, wd):
    state, jstate = _run_both(
        "cnn", small_fed_data, 1,
        dict(momentum=momentum, weight_decay=wd), None)
    _assert_state_close(state, jstate, TOL_1)


def test_masked_out_team_and_devices_keep_their_models(small_fed_data):
    """A masked-out team keeps its w; devices outside the mask keep their
    theta; a participating team without devices moves by eq. 9 with the
    team mean replaced by w."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import permfl as P

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    train, _ = _data(fd)
    hp = P.PerMFLHParams(k_team=2, l_local=2)
    s0 = P.init_state(params_from_numpy(_jax_init("cnn")), m, n)
    s0.theta += 1.0          # distinguish kept device models from x
    s0.w -= 1.0
    s1 = P.permfl_round(s0, params_from_numpy(train), hp,
                        _port_fns("cnn")[0], m_teams=m, n_devices=n,
                        team_mask=torch.from_numpy(TEAM_MASK),
                        device_mask=torch.from_numpy(DEVICE_MASK))
    assert torch.equal(s1.w[1], s0.w[1])
    for i, j in zip(*np.nonzero(DEVICE_MASK == 0)):
        assert torch.equal(s1.theta[i, j], s0.theta[i, j])
    for i, j in zip(*np.nonzero(DEVICE_MASK)):
        assert not torch.equal(s1.theta[i, j], s0.theta[i, j])
    c = 1.0 - hp.eta * hp.lam - hp.eta * hp.gamma
    w = s0.x.clone()
    for _ in range(hp.k_team):            # team 2: theta_bar = w
        w = c * w + hp.eta * hp.gamma * s0.x + hp.lam * hp.eta * w
    torch.testing.assert_close(s1.w[2], w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("which", ["pm", "tm", "gm"])
def test_eval_stacked_matches_jax(small_fed_data, cnn_masked_round, which):
    """PM/TM/GM (M, N) accuracy matrices after one masked CNN round:
    equal, or apart by at most one validation sample's share."""
    fd = small_fed_data
    state, jstate = cnn_masked_round
    from repro_torch.core import permfl as P
    from repro_torch.convert import params_from_numpy

    _, val = _data(fd)
    got = P.eval_stacked(state, params_from_numpy(val), _port_fns("cnn")[1],
                         which=which)
    want = np.asarray(JP.eval_stacked(jstate, jax.tree.map(jnp.asarray, val),
                                      _jax_fns("cnn")[1], which=which))
    assert got.shape == want.shape == (fd.m_teams, fd.n_devices)
    one_sample = 1.0 / fd.val_y.shape[-1]
    assert np.abs(got.numpy() - want).max() <= one_sample + 1e-6


def test_tier_norms_match_jax(cnn_masked_round):
    state, jstate = cnn_masked_round
    from repro_torch.core import permfl as P

    gap, drift = P.tier_norms(state)
    jgap, jdrift = jax.jit(JP.tier_norms)(jstate)
    np.testing.assert_allclose(gap.numpy(), np.asarray(jgap), **TOL_1)
    np.testing.assert_allclose(drift.numpy(), np.asarray(jdrift), **TOL_1)


def test_round_continues_a_converted_jax_state(small_fed_data,
                                               cnn_masked_round):
    """A JAX state carried over by ``state_from_numpy`` round-trips through
    ``to_numpy`` exactly, and one more round of each implementation from
    it agrees."""
    from repro_torch.convert import params_from_numpy, state_from_numpy
    from repro_torch.convert import to_numpy
    from repro_torch.core import permfl as P

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    _, jstate = cnn_masked_round
    as_np = {k: jax.tree.map(np.asarray, getattr(jstate, k))
             for k in ("x", "w", "theta")}
    state = state_from_numpy({**as_np, "round": int(jstate.round)})
    assert state.round == 1
    back = to_numpy(state)
    for tier in ("x", "w", "theta"):
        jax.tree.map(np.testing.assert_array_equal, back[tier], as_np[tier])
    train, _ = _data(fd)
    jhp = JP.PerMFLHParams(k_team=2, l_local=2)
    jnext = JP.permfl_round(jstate, jax.tree.map(jnp.asarray, train), jhp,
                            _jax_fns("cnn")[0], m_teams=m, n_devices=n)
    nxt = P.permfl_round(state, params_from_numpy(train),
                         P.PerMFLHParams(k_team=2, l_local=2),
                         _port_fns("cnn")[0], m_teams=m, n_devices=n)
    _assert_state_close(nxt, jnext, TOL_1)


def test_round_refuses_comm(small_fed_data):
    """Once: a lossy compressor without error feedback was refused. Now
    the non-EF uplinks run, and identity with error_feedback=False still
    sends ``theta - anchor + ef``: from a JAX state whose residuals are
    nonzero, one round of each implementation agrees, both leave the
    residuals as they were, and the result differs from the round with
    zero residuals (so ``ef`` really rode the message)."""
    from repro.comm import CommConfig as JCommConfig
    from repro.comm.config import CommState as JCommState
    from repro_torch.comm import CommConfig
    from repro_torch.convert import params_from_numpy, state_from_numpy
    from repro_torch.core import permfl as P

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    jcfg = JCommConfig("identity", error_feedback=False)
    cfg = CommConfig("identity", error_feedback=False)
    js0 = JP.init_state(_jax_init("mclr"), m, n, comm=jcfg)
    rng = np.random.default_rng(4)
    ef = jax.tree.map(lambda t: jnp.asarray(
        1e-3 * rng.standard_normal(t.shape).astype(np.float32)),
        {"ef_dev": js0.comm.ef_dev, "ef_team": js0.comm.ef_team})
    js = dataclasses.replace(
        js0, comm=JCommState(key=js0.comm.key, **ef))
    train, _ = _data(fd)
    jhp = JP.PerMFLHParams(k_team=2, l_local=2)
    jnext = JP.permfl_round(js, jax.tree.map(jnp.asarray, train), jhp,
                            _jax_fns("mclr")[0], m_teams=m, n_devices=n,
                            comm=jcfg)
    as_np = {k: jax.tree.map(np.asarray, getattr(js, k))
             for k in ("x", "w", "theta")}
    as_np["comm"] = jax.tree.map(np.asarray, ef)
    state = state_from_numpy(as_np)
    hp = P.PerMFLHParams(k_team=2, l_local=2)
    nxt = P.permfl_round(state, params_from_numpy(train), hp,
                         _port_fns("mclr")[0], m_teams=m, n_devices=n,
                         comm=cfg)
    _assert_state_close(nxt, jnext, TOL_1)
    assert torch.equal(nxt.comm.ef_dev, state.comm.ef_dev)
    assert torch.equal(nxt.comm.ef_team, state.comm.ef_team)
    zero = P.init_state(params_from_numpy(_jax_init("mclr")), m, n,
                        comm=cfg)
    plain = P.permfl_round(zero, params_from_numpy(train), hp,
                           _port_fns("mclr")[0], m_teams=m, n_devices=n,
                           comm=cfg)
    assert float((plain.x - nxt.x).abs().max()) > 1e-5
