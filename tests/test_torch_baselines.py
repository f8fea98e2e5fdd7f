"""The port's six Table-1 baselines (``repro_torch.core.baselines``)
against the JAX package's (``repro.core.baselines``): each round
function for one and two rounds on MCLR (``small_fed_data``) and the DNN
(``tabular_fed_data``), Per-FedAvg's second-order round once on a narrow
CNN; each ``run_<algo>`` history with a remainder chunk; the state's
crossing in both directions; and the serving identity of all seven
algorithms. The reference's initial parameters and states enter through
``convert.params_from_numpy`` / ``baseline_state_from_numpy``.

Tolerances: one round rtol 1e-5 / atol 1e-6, two or more rtol 1e-4 /
atol 1e-4 (XLA's and torch's CPU matmuls sum in different orders, and
the gap grows with the rounds); accuracies within one validation sample.
"""
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
from repro.core import baselines as JB  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro.train import fl_trainer as JFT  # noqa: E402

TOL_1 = dict(rtol=1e-5, atol=1e-6)
TOL_N = dict(rtol=1e-4, atol=1e-4)

# small loop counts keep the JAX compiles short; pFedMe keeps the
# registered lr = 1, lam = 15 (w <- w - 15 (w - theta))
HP = {
    "fedavg": dict(lr=0.05, local_steps=3),
    "perfedavg": dict(lr=0.05, inner_lr=0.04, local_steps=2),
    "pfedme": dict(lr=1.0, inner_lr=0.03, lam=15.0, inner_steps=3,
                   local_rounds=2),
    "ditto": dict(lr=0.05, lam=0.5, local_steps=3),
    "hsgd": dict(lr=0.05, k_team=2, l_local=2),
    "l2gd": dict(lr=0.05, lam_c=0.5, lam_g=0.5, k_team=2, l_local=2),
}
PERSONAL = ("pfedme", "ditto", "l2gd")
ALGOS = tuple(HP)
# the narrow CNN of the second-order case: the paper CNN's layers at
# a tenth of its widths
NARROW = dict(conv_channels=(4, 8), hidden=(16,))


def _port_cfg(kind):
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.paper_dnn import CONFIG as DNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    cfg = {"mclr": MCLR, "dnn": DNN, "cnn": CNN}[kind]
    return dataclasses.replace(cfg, **NARROW) if kind == "cnn" else cfg


def _jax_cfg(kind):
    cfg = {"mclr": J_MCLR, "dnn": J_DNN, "cnn": J_CNN}[kind]
    return dataclasses.replace(cfg, **NARROW) if kind == "cnn" else cfg


@functools.lru_cache(maxsize=None)
def _jax_fns(kind):
    """One loss/metric pair per model: the jitted rounds cache on the
    loss function's identity."""
    cfg = _jax_cfg(kind)
    return (lambda p, b: JPM.loss_fn(p, cfg, b),
            lambda p, b: JPM.accuracy(p, cfg, b))


def _port_fns(kind):
    from repro_torch.scenarios.spec import fns_for
    return fns_for(_port_cfg(kind))


def _fd(kind, request):
    return request.getfixturevalue(
        "tabular_fed_data" if kind == "dnn" else "small_fed_data")


def _close(got, want, tol, what):
    """Nested numpy ``got`` against the JAX tree ``want``."""
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), err_msg=what, **tol), got, want)


def _jax_round(algo, state, data, loss, m, n):
    kw = dict(loss_fn=loss, m=m, n=n, **HP[algo])
    if algo == "pfedme":
        return JB.pfedme_round(state[0], data, **kw)
    if algo == "ditto":
        return JB.ditto_round(*state, data, **kw)
    if algo == "l2gd":
        return JB.l2gd_round(*state, data, **kw)
    return getattr(JB, f"{algo}_round")(state, data, **kw)


def _port_round(algo, state, data, loss, m, n):
    from repro_torch.core import baselines as B
    from repro_torch.core.baselines import BaselineState

    kw = dict(loss_fn=loss, m=m, n=n, **HP[algo])
    fn = getattr(B, f"{algo}_round")
    if algo in ("ditto", "l2gd"):
        x, p = fn(state.x, state.personal, data, state.layout, **kw)
    else:
        out = fn(state.x, data, state.layout, **kw)
        x, p = out if algo == "pfedme" else (out, None)
    return BaselineState(x, state.layout, p, state.round + 1)


def _run_rounds(algo, kind, fd, rounds):
    """``rounds`` rounds in both packages from the JAX init; yields each
    round's (port numpy state, JAX state)."""
    from repro_torch.convert import baseline_state_from_numpy, to_numpy

    m, n = fd.m_teams, fd.n_devices
    train = {"x": fd.train_x, "y": fd.train_y}
    params0 = JPM.init_params(jax.random.PRNGKey(1), _jax_cfg(kind))
    jstate = (params0, JB._bcast(params0, (m, n))) \
        if algo in PERSONAL else params0
    state = baseline_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jtrain = jax.tree.map(jnp.asarray, train)
    ttrain = {k: torch.from_numpy(v) for k, v in train.items()}
    loss, jloss = _port_fns(kind)[0], _jax_fns(kind)[0]
    for _ in range(rounds):
        jstate = _jax_round(algo, jstate, jtrain, jloss, m, n)
        state = _port_round(algo, state, ttrain, loss, m, n)
        yield to_numpy(state), jstate


@pytest.mark.parametrize("kind", ["mclr", "dnn"])
@pytest.mark.parametrize("algo", ALGOS)
def test_round_matches_jax(algo, kind, request):
    """Round 1 at the one-round tolerance, round 2 at the longer one."""
    fd = _fd(kind, request)
    for r, (got, jstate) in enumerate(_run_rounds(algo, kind, fd, 2)):
        _close(got, jstate, TOL_1 if r == 0 else TOL_N,
               f"{algo} {kind} round {r + 1}")


def test_perfedavg_second_order_round_on_a_cnn(small_fed_data):
    """Per-FedAvg differentiates through its inner gradient (conv,
    max-pool, ReLU, twice); the JAX meta-gradient is the reference."""
    (got, jx), = _run_rounds("perfedavg", "cnn", small_fed_data, 1)
    _close(got, jx, TOL_1, "perfedavg cnn")


def test_meta_grads_are_second_order(small_fed_data):
    """The meta-gradient differs from the first-order one (the gradient at
    the adapted point) by the Hessian term the reference keeps."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.baselines import meta_grads
    from repro_torch.core.permfl import device_grads
    from repro_torch.flat import Layout

    fd = small_fed_data
    d = fd.m_teams * fd.n_devices
    p0 = params_from_numpy(jax.tree.map(np.asarray, JPM.init_params(
        jax.random.PRNGKey(1), _jax_cfg("cnn"))))
    layout = Layout.of(p0)
    theta = layout.flatten(p0).expand(d, -1).clone()
    batch = {"x": torch.from_numpy(fd.train_x.reshape(
                 (d,) + fd.train_x.shape[2:])),
             "y": torch.from_numpy(fd.train_y.reshape(d, -1))}
    loss = _port_fns("cnn")[0]
    mg = meta_grads(loss, layout, theta, batch, 0.04)
    g = device_grads(loss, layout, theta, batch)
    first = device_grads(loss, layout, theta - 0.04 * g, batch)
    assert mg.shape == theta.shape and not torch.equal(mg, first)
    assert int(torch.count_nonzero(mg[:, layout.size:])) == 0
    # per device: the meta-gradient of the first device alone
    one = meta_grads(loss, layout, theta[:1], {k: v[:1] for k, v in
                                               batch.items()}, 0.04)
    torch.testing.assert_close(mg[:1], one, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ histories

@pytest.mark.parametrize("algo", ALGOS)
def test_run_history_matches_jax(algo, small_fed_data):
    """``run_<algo>``: 3 rounds, eval every 2 (evals after rounds 2 and
    3): the same metric keys and lengths, accuracies within one
    validation sample, the final state within the longer tolerance."""
    from repro_torch.convert import to_numpy
    from repro_torch.train import fl_trainer as FT

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    train = {"x": fd.train_x, "y": fd.train_y}
    val = {"x": fd.val_x, "y": fd.val_y}
    params0 = JPM.init_params(jax.random.PRNGKey(2), J_MCLR)
    jloss, jmet = _jax_fns("mclr")
    jres = JFT.ALGORITHMS[algo](
        params0, jax.tree.map(jnp.asarray, train),
        jax.tree.map(jnp.asarray, val), loss_fn=jloss, metric_fn=jmet,
        rounds=3, m=m, n=n, eval_every=2, **HP[algo])
    loss, met = _port_fns("mclr")
    res = FT.ALGORITHMS[algo](
        jax.tree.map(np.asarray, params0), train, val, loss_fn=loss,
        metric_fn=met, rounds=3, m=m, n=n, eval_every=2, device="cpu",
        **HP[algo])
    n_val = fd.val_y.shape[-1]
    for field in ("pm_acc", "tm_acc", "gm_acc", "train_loss"):
        got, want = getattr(res, field), getattr(jres, field)
        assert len(got) == len(want), field
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1.0 / n_val + 1e-6, err_msg=field)
    assert len(res.gm_acc) == 2 and res.participation == jres.participation
    assert res.state.round == 3
    _close(to_numpy(res.state), jres.state, TOL_N, f"{algo} final state")


@pytest.mark.parametrize("algo", ALGOS)
def test_baselines_refuse_sampled_participation(algo):
    from repro_torch.core import baselines as B
    from repro_torch.train.engine import run_experiment
    from repro_torch.train.fl_trainer import ALGORITHMS

    assert algo in ALGORITHMS
    cls = {"fedavg": B.FedAvg, "perfedavg": B.PerFedAvg, "pfedme": B.PFedMe,
           "ditto": B.Ditto, "hsgd": B.HSGD, "l2gd": B.L2GD}[algo]
    assert not cls.supports_participation
    with pytest.raises(ValueError, match="ignores participation"):
        run_experiment(cls(None, **HP[algo]), {}, {}, {}, metric_fn=None,
                       rounds=1, m=1, n=1, team_frac=0.5, device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
def test_state_crosses_both_ways(algo):
    """The reference's state (``x`` or ``(x, personal)``) to the port's
    and back, bit for bit."""
    from repro_torch.convert import baseline_state_from_numpy, to_numpy

    p = jax.tree.map(np.asarray, JPM.init_params(jax.random.PRNGKey(4),
                                                 J_DNN))
    rng = np.random.default_rng(0)
    personal = jax.tree.map(
        lambda a: rng.standard_normal((2, 3) + a.shape).astype(np.float32),
        p)
    jstate = (p, personal) if algo in PERSONAL else p
    state = baseline_state_from_numpy(jstate, round=5)
    assert state.round == 5 and (state.personal is None) == (
        algo not in PERSONAL)
    back = to_numpy(state)
    jax.tree.map(np.testing.assert_array_equal, back, jstate)
    assert float(state.x[state.layout.size:].abs().sum()) == 0.0


# ------------------------------------------------------------ serving

ALL_ALGOS = ("permfl",) + ALGOS


@functools.lru_cache(maxsize=None)
def _jax_trained(algo):
    """A JAX state after one round of ``table1/mnist/mclr/{algo}`` at 2
    teams x 3 devices (loop counts cut), with its build."""
    from repro.scenarios import SCENARIOS, build_scenario

    ov = ({"k_team": 2, "l_local": 2} if algo == "permfl" else
          {k: v for k, v in HP[algo].items() if isinstance(v, int)})
    s = SCENARIOS[f"table1/mnist/mclr/{algo}"].scaled(
        m_teams=2, n_devices=3, samples_per_device=16, rounds=1,
        algo_overrides=ov)
    b = build_scenario(s, seed=0)
    m, n = b.m, b.n
    state = b.algo.round(b.algo.init_state(b.params0, m, n), b.train,
                         team_mask=jnp.ones(m), device_mask=jnp.ones((m, n)))
    return s, b, state


@pytest.mark.parametrize("algo", ALL_ALGOS)
def test_serving_identity_matches_jax(algo):
    """From one JAX-trained state carried across: the port's store rows
    equal its ``serving_params``, which equal the reference's for every
    principal (device, team, global); the same for a state the port
    trained itself."""
    from repro_torch.convert import (baseline_state_from_numpy,
                                     state_from_numpy)
    from repro_torch.scenarios import build_scenario
    from repro_torch.serve import ModelStore

    s, jb, jstate = _jax_trained(algo)
    b = build_scenario(s.to_dict(), seed=0, device="cpu")
    m, n = b.m, b.n
    if algo == "permfl":
        state = state_from_numpy({
            t: jax.tree.map(np.asarray, getattr(jstate, t))
            for t in ("x", "w", "theta")})
    else:
        state = baseline_state_from_numpy(jax.tree.map(np.asarray, jstate))
    ts, ds = np.repeat(np.arange(m), n), np.tile(np.arange(n), m)
    for enc in ("delta", "raw"):
        store = ModelStore.from_state(b.algo, state, m=m, n=n,
                                      encoding=enc)
        rows = store.gather(ts, ds)
        for i, (t, d) in enumerate(zip(ts, ds)):
            want = jb.algo.serving_params(jstate, int(t), int(d))
            assert torch.equal(rows[i], b.algo.serving_params(
                state, int(t), int(d)))
            jax.tree.map(lambda a, w: np.testing.assert_array_equal(
                a, np.asarray(w)),
                state.layout.unflatten(rows[i]), want)
        for t in range(m):
            jax.tree.map(lambda a, w: np.testing.assert_array_equal(
                a.numpy(), np.asarray(w)),
                state.layout.unflatten(store.team_rows[t]),
                jb.algo.serving_params(jstate, t))
        jax.tree.map(lambda a, w: np.testing.assert_array_equal(
            a.numpy(), np.asarray(w)),
            state.layout.unflatten(store.global_row),
            jb.algo.serving_params(jstate))
    # the port's own trained state: store rows == serving_params
    own = b.algo.round(b.algo.init_state(b.params0, m, n), b.train,
                       team_mask=torch.ones(m), device_mask=torch.ones(m, n))
    store = ModelStore.from_state(b.algo, own, m=m, n=n)
    idx = torch.arange(m)[:, None], torch.arange(n)[None]
    assert torch.equal(store.gather(ts, ds).view(m, n, -1),
                       b.algo.serving_params(own, *idx))
    assert torch.equal(store.global_row, b.algo.serving_params(own))
