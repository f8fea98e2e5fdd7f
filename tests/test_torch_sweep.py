"""The port's stacked sweep (``repro_torch.train.sweep``) against the JAX
package's ``repro.train.sweep.run_sweep`` and against its own looped
``run_experiment``: PerMFL (a 3-point grid x 2 seeds, per-seed inits),
pFedMe and Per-FedAvg, a compressed sweep under sampled participation
with the reference's masks and uniforms injected per config; every
algorithm's configs against their looped runs; the refusals, grid
semantics, an eval remainder, ``sweep_scenario``, the stacked state's
crossing, and the prox step's per-config hyperparameters.

Tolerances. Against the reference: those of the baseline and engine
suites -- accuracies within one validation sample, losses and states
rtol 1e-4 / atol 1e-4 (XLA's and PyTorch's CPU matmuls sum in another
order, and the gap grows with the rounds). Against the port's own looped
runs: equal, bit for bit. A config's coefficients are cast to float32
from the same float64 expression as its looped run's, every op of the
stacked round is elementwise or a reduction over the same axis, and the
SGD steps are ``theta - lr * g`` in both.

Sizes: MCLR on ``small_fed_data`` (4 teams x 3 devices), K = L = 2, two
or three rounds; the initial models are small random MCLR weights from
numpy (the paper's MCLR starts at zeros, which would make every seed's
init the same).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.comm import CommConfig as JCommConfig  # noqa: E402
from repro.configs.paper_mclr import CONFIG as J_MCLR  # noqa: E402
from repro.core import PerMFL as JPerMFL  # noqa: E402
from repro.core import PerMFLHParams as JHParams  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core.participation import sample_masks as j_sample_masks  # noqa: E402,E501
from repro.models import paper_models as JPM  # noqa: E402
from repro.train import sweep as JS  # noqa: E402

HP = dict(alpha=0.05, eta=0.04, beta=0.3, lam=0.8, gamma=2.0, k_team=2,
          l_local=2)
# non-uniform on purpose: different keys set per config
GRID = [dict(lam=0.3), dict(lam=0.9, beta=0.5), dict(gamma=1.0)]
SEEDS = (0, 7)
TOL = dict(rtol=1e-4, atol=1e-4)
BASELINES = {
    "fedavg": (dict(lr=0.05, local_steps=2), [dict(lr=0.05), dict(lr=0.1)]),
    "perfedavg": (dict(lr=0.05, inner_lr=0.04, local_steps=2),
                  [dict(lr=0.05), dict(lr=0.1, inner_lr=0.02)]),
    "pfedme": (dict(lr=1.0, inner_lr=0.03, lam=15.0, inner_steps=2,
                    local_rounds=2), [dict(lam=15.0), dict(inner_lr=0.05)]),
    "ditto": (dict(lr=0.05, lam=0.5, local_steps=2),
              [dict(lr=0.05), dict(lr=0.1, lam=0.2)]),
    "hsgd": (dict(lr=0.05, k_team=2, l_local=2), [dict(lr=0.05),
                                                   dict(lr=0.2)]),
    "l2gd": (dict(lr=0.05, lam_c=0.5, lam_g=0.5, k_team=2, l_local=2),
             [dict(lam_c=0.2), dict(lam_g=0.9, lr=0.1)]),
}
CLASSES = {"fedavg": "FedAvg", "perfedavg": "PerFedAvg", "pfedme": "PFedMe",
           "ditto": "Ditto", "hsgd": "HSGD", "l2gd": "L2GD"}


def init(seed):
    """A small random MCLR model (numpy), one per seed."""
    rng = np.random.default_rng(100 + seed)
    return {"b": (0.01 * rng.standard_normal(10)).astype(np.float32),
            "w": (0.01 * rng.standard_normal((784, 10))).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def jax_fns():
    """One loss/metric pair: the reference's compiled programs cache on
    the functions' identity."""
    return (lambda p, b: JPM.loss_fn(p, J_MCLR, b),
            lambda p, b: JPM.accuracy(p, J_MCLR, b))


def port_fns():
    from repro_torch.configs.paper_mclr import CONFIG
    from repro_torch.scenarios.spec import fns_for
    return fns_for(CONFIG)


def batches(fd):
    return ({"x": fd.train_x, "y": fd.train_y},
            {"x": fd.val_x, "y": fd.val_y})


def jax_sweep(algo, grid, fd, rounds, **kw):
    train, val = (jax.tree.map(jnp.asarray, d) for d in batches(fd))
    return JS.run_sweep(algo, grid, SEEDS,
                        lambda s: jax.tree.map(jnp.asarray, init(s)),
                        train, val, metric_fn=jax_fns()[1], rounds=rounds,
                        m=fd.m_teams, n=fd.n_devices, **kw)


def port_sweep(algo, grid, fd, rounds, **kw):
    from repro_torch.train.sweep import run_sweep
    train, val = batches(fd)
    return run_sweep(algo, grid, SEEDS, init, train, val,
                     metric_fn=port_fns()[1], rounds=rounds, m=fd.m_teams,
                     n=fd.n_devices, device="cpu", **kw)


def port_looped(algo, grid, fd, rounds, masks=None, uniforms=None, **kw):
    """The port's run_experiment of every config, grid-major."""
    from repro_torch.train.engine import run_experiment
    train, val = batches(fd)
    _, rebuild = algo.tree_hparams()
    out = []
    for g in grid:
        for s in SEEDS:
            i = len(out)
            extra = {} if masks is None else {"masks": masks[i]}
            if uniforms is not None:
                extra["uniforms"] = uniforms[i]
            out.append(run_experiment(
                rebuild(g), init(s), train, val, metric_fn=port_fns()[1],
                rounds=rounds, m=fd.m_teams, n=fd.n_devices, seed=s,
                device="cpu", **kw, **extra))
    return out


def assert_close_to_reference(res, jres, n_val):
    for f in ("pm_acc", "tm_acc", "gm_acc"):
        got, want = getattr(res, f), getattr(jres, f)
        assert len(got) == len(want), f
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1.0 / n_val + 1e-6, err_msg=f)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, **TOL)
    assert res.participation == jres.participation


def assert_equal_runs(res, ref):
    """A swept config equals its looped run bit for bit."""
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        assert getattr(res, f) == getattr(ref, f), f
    for f in ("x", "w", "theta", "personal"):
        a = getattr(res.state, f, None)
        if a is not None:
            assert torch.equal(a, getattr(ref.state, f)), f
    if getattr(res.state, "comm", None) is not None:
        for f in ("ef_dev", "ef_team"):
            assert torch.equal(getattr(res.state.comm, f),
                               getattr(ref.state.comm, f)), f
        assert res.comm.total_bytes() == ref.comm.total_bytes()
        assert len(res.comm.rounds) == res.rounds


def permfl_state_numpy(jstate):
    """A reference PerMFLState as the dict ``convert`` takes."""
    out = {k: jax.tree.map(np.asarray, getattr(jstate, k))
           for k in ("x", "w", "theta")}
    out["round"] = np.asarray(jstate.round)
    return out


# ------------------------------------------------------------ against JAX

def test_permfl_sweep_matches_reference_and_looped(small_fed_data):
    """3 grid points x 2 seeds with per-seed inits, 2 rounds: each config
    against the reference's swept config, and equal to the port's looped
    run; the stacked state crosses from the reference's."""
    from repro_torch.convert import sweep_state_from_numpy
    from repro_torch.core import PerMFL, PerMFLHParams

    fd = small_fed_data
    jsw = jax_sweep(JPerMFL(jax_fns()[0], JHParams(**HP)), GRID, fd, 2)
    algo = PerMFL(port_fns()[0], PerMFLHParams(**HP))
    sw = port_sweep(algo, GRID, fd, 2)
    assert len(sw) == 6 and len(jsw) == 6
    assert sw.configs == [dict(c) for c in jsw.configs]
    for res, jres, ref in zip(sw, jsw, port_looped(algo, GRID, fd, 2)):
        assert_close_to_reference(res, jres, fd.val_y.shape[-1])
        assert_equal_runs(res, ref)
    st = sweep_state_from_numpy(permfl_state_numpy(jsw.state_stacked))
    assert sw.state_stacked.theta.shape == (6, 4, 3, st.layout.stride)
    for tier in ("x", "w", "theta"):
        np.testing.assert_allclose(getattr(sw.state_stacked, tier).numpy(),
                                   getattr(st, tier).numpy(), **TOL,
                                   err_msg=tier)
    assert sw[0].tm_acc != sw[1].tm_acc     # the seeds' inits differ


@pytest.mark.parametrize("name", ["pfedme", "perfedavg"])
def test_baseline_sweep_matches_reference_and_looped(small_fed_data, name):
    """A prox-step baseline and the second-order one: 2 grid points x 2
    seeds, 2 rounds, each config against the reference's and equal to
    its looped run; the stacked state crosses from the reference's."""
    from repro_torch.convert import sweep_state_from_numpy
    from repro_torch.core import baselines as B

    fd = small_fed_data
    hp, grid = BASELINES[name]
    jsw = jax_sweep(getattr(JB, CLASSES[name])(jax_fns()[0], **hp), grid,
                    fd, 2)
    algo = getattr(B, CLASSES[name])(port_fns()[0], **hp)
    sw = port_sweep(algo, grid, fd, 2)
    for res, jres, ref in zip(sw, jsw, port_looped(algo, grid, fd, 2)):
        for f in ("pm_acc", "gm_acc"):
            np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                       rtol=0, atol=1.0 / fd.val_y.shape[-1]
                                       + 1e-6, err_msg=f)
        assert_equal_runs(res, ref)
    st = sweep_state_from_numpy(jax.tree.map(np.asarray, jsw.state_stacked))
    np.testing.assert_allclose(sw.state_stacked.x.numpy(), st.x.numpy(),
                               **TOL)
    if st.personal is not None:
        np.testing.assert_allclose(sw.state_stacked.personal.numpy(),
                                   st.personal.numpy(), **TOL)


def _reference_masks(seed, rounds, m, n, **fracs):
    """The reference engine's mask chain of one config: split the carried
    key every round."""
    key, chain = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        chain.append(tuple(np.asarray(a) for a in j_sample_masks(
            sub, m, n, **fracs)))
    return chain.__getitem__


@functools.lru_cache(maxsize=None)
def _uniform_fn(b, sizes):
    def draw(key):
        return jnp.concatenate([
            jax.vmap(lambda q, p=p: jax.random.uniform(q, (p,)))(
                jax.random.split(jax.random.fold_in(key, i), b))
            for i, p in enumerate(sizes)], axis=1)
    return jax.jit(draw)


def _reference_uniforms(seed, sizes):
    """The reference's rand-k / int8 uniforms of uplink k of round t:
    ``fold_in(fold_in(PRNGKey(seed), t), k)``, per leaf i ``split(
    fold_in(key, i), b)``, leaves back to back (as in
    ``test_torch_comm.py``)."""
    base = jax.random.PRNGKey(seed)

    def src(t, k, b):
        key = jax.random.fold_in(jax.random.fold_in(base, t), k)
        return np.array(_uniform_fn(b, tuple(sizes))(key))
    return src


def test_compressed_sampled_sweep_matches_reference(small_fed_data):
    """Rand-k with error feedback under sampled participation (half the
    teams): the reference's masks (each config's own chain) and uniforms
    (the comm seed's stream, shared by every config, as in the
    reference) injected per config; metrics, participation, states,
    residuals and byte ledgers against the reference's sweep, and equal
    to the port's looped runs given the same streams. Rand-k chooses on
    the uniforms alone, so nothing flips between the frameworks."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import PerMFL, PerMFLHParams

    fd = small_fed_data
    m, n = fd.m_teams, fd.n_devices
    fracs = dict(team_frac=0.5, device_frac=1.0)
    jcomm = JCommConfig("randk", k_frac=0.3)
    jsw = jax_sweep(JPerMFL(jax_fns()[0], JHParams(**HP), comm=jcomm),
                    GRID[:2], fd, 2, **fracs)
    masks = [_reference_masks(s, 2, m, n, **fracs) for _ in GRID[:2]
             for s in SEEDS]
    sizes = [int(np.prod(v.shape)) for v in jax.tree.leaves(init(0))]
    uniforms = [_reference_uniforms(jcomm.seed, sizes)] * len(masks)
    algo = PerMFL(port_fns()[0], PerMFLHParams(**HP),
                  comm=CommConfig("randk", k_frac=0.3))
    sw = port_sweep(algo, GRID[:2], fd, 2, masks=masks, uniforms=uniforms,
                    **fracs)
    looped = port_looped(algo, GRID[:2], fd, 2, masks=masks,
                         uniforms=uniforms, **fracs)
    for i, (res, jres, ref) in enumerate(zip(sw, jsw, looped)):
        assert_close_to_reference(res, jres, fd.val_y.shape[-1])
        assert res.comm.total_bytes() == jres.comm.total_bytes()
        assert_equal_runs(res, ref)
        jst = jax.tree.map(lambda a: np.asarray(a)[i], jsw.state_stacked)
        for tier in ("x", "w", "theta"):
            np.testing.assert_allclose(
                res.state.layout.columns(getattr(res.state, tier)).numpy(),
                np.concatenate([np.asarray(v).reshape(
                    np.asarray(v).shape[:{"x": 0, "w": 1, "theta": 2}[tier]]
                    + (-1,)) for v in jax.tree.leaves(getattr(jst, tier))],
                    axis=-1), **TOL, err_msg=tier)
        np.testing.assert_allclose(
            res.state.layout.columns(res.state.comm.ef_team).numpy(),
            np.concatenate([np.asarray(v).reshape(m, -1) for v in
                            jax.tree.leaves(jst.comm.ef_team)], axis=-1),
            **TOL)
    assert {r.participation[0][0] for r in sw} == {2}


# --------------------------------------------------- against looped runs

@pytest.mark.parametrize("name", list(BASELINES))
def test_every_baseline_sweep_equals_looped(small_fed_data, name):
    from repro_torch.core import baselines as B

    hp, grid = BASELINES[name]
    algo = getattr(B, CLASSES[name])(port_fns()[0], **hp)
    sw = port_sweep(algo, grid, small_fed_data, 2)
    for res, ref in zip(sw, port_looped(algo, grid, small_fed_data, 2)):
        assert_equal_runs(res, ref)


@pytest.mark.parametrize("compressor,ef,team_frac", [
    ("topk", True, 0.5), ("int8", True, 1.0), ("sign", False, 0.5),
    ("randk", False, 1.0)])
def test_compressed_permfl_sweep_equals_looped(small_fed_data, compressor,
                                               ef, team_frac):
    """The port's own generators: each config's uniforms from its own
    generator (seeded as its looped run's), each config's masks from one
    seeded with its seed."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import PerMFL, PerMFLHParams

    algo = PerMFL(port_fns()[0], PerMFLHParams(**HP),
                  comm=CommConfig(compressor, k_frac=0.3,
                                  error_feedback=ef))
    sw = port_sweep(algo, GRID, small_fed_data, 2, team_frac=team_frac)
    looped = port_looped(algo, GRID, small_fed_data, 2,
                         team_frac=team_frac)
    for res, ref in zip(sw, looped):
        assert_equal_runs(res, ref)


def test_eval_every_remainder(small_fed_data):
    from repro_torch.core import PerMFL, PerMFLHParams

    algo = PerMFL(port_fns()[0], PerMFLHParams(**HP))
    sw = port_sweep(algo, [dict(lam=0.4)], small_fed_data, 3,
                    eval_every=2)
    assert [len(r.pm_acc) for r in sw] == [2, 2]  # after rounds 2 and 3
    assert [len(r.participation) for r in sw] == [3, 3]
    assert len(sw.round_seconds) == 3
    for res, ref in zip(sw, port_looped(algo, [dict(lam=0.4)],
                                        small_fed_data, 3, eval_every=2)):
        assert_equal_runs(res, ref)


# ----------------------------------------------------- grid, API, refusals

def test_grid_product_matches_reference():
    from repro_torch.train.sweep import grid_product

    axes = dict(a=[1, 2], b=[3], c=[0.5, 0.25])
    assert grid_product(**axes) == JS.grid_product(**axes)
    assert grid_product(a=[1, 2], b=[3]) == [{"a": 1, "b": 3},
                                             {"a": 2, "b": 3}]


def test_dict_grid_is_a_product(small_fed_data):
    from repro_torch.core import PerMFL, PerMFLHParams

    sw = port_sweep(PerMFL(port_fns()[0], PerMFLHParams(**HP)),
                    {"lam": [0.3, 0.9], "beta": [0.5]}, small_fed_data, 1)
    assert [c["lam"] for c in sw.configs] == [0.3, 0.3, 0.9, 0.9]
    assert [c["seed"] for c in sw.configs] == [0, 7, 0, 7]
    assert all(c["beta"] == 0.5 and c["alpha"] == HP["alpha"]
               for c in sw.configs)


def test_result_accessors_and_best(small_fed_data):
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.train.engine import FLResult
    from repro_torch.train.sweep import FLSweepResult

    sw = port_sweep(PerMFL(port_fns()[0], PerMFLHParams(**HP)), GRID,
                    small_fed_data, 2)
    assert isinstance(sw, FLSweepResult) and len(sw) == 6
    assert [r.pm_acc[-1] for r in sw] == sw.final("pm")
    assert sw.best("gm") == [max(r.gm_acc) for r in sw]
    assert sw[2] is list(sw)[2]
    assert sw.seconds == pytest.approx(sum(sw.round_seconds))
    assert sw[0].seconds == pytest.approx(sw.seconds / 6)
    r = FLResult(pm_acc=[0.2, 0.5, 0.4])
    assert r.best("pm") == 0.5 and r.last("pm") == 0.4
    assert np.isnan(r.best("tm")) and np.isnan(r.last("tm"))


@pytest.mark.parametrize("name", list(BASELINES))
def test_tree_hparams_and_skeleton_match_the_reference(name):
    from repro_torch.core import baselines as B
    from repro_torch.train.engine import hparam_skeleton

    from repro.train.engine import hparam_skeleton as j_skeleton

    hp, _ = BASELINES[name]
    algo = getattr(B, CLASSES[name])(None, **hp)
    jalgo = getattr(JB, CLASSES[name])(None, **hp)
    leaves, rebuild = algo.tree_hparams()
    assert leaves == jalgo.tree_hparams()[0]
    key = next(iter(leaves))
    assert getattr(rebuild({key: 0.125}), key) == 0.125
    skel, sleaves = hparam_skeleton(algo)
    jskel, _ = j_skeleton(jalgo)
    assert sleaves == leaves
    assert all(getattr(skel, k) == getattr(jskel, k) == 0.0 for k in leaves)


@pytest.mark.parametrize("case", ["unknown", "empty_grid", "empty_seeds",
                                  "mask_blind", "masks_count"])
def test_refusals(small_fed_data, case):
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.core import baselines as B
    from repro_torch.train.sweep import run_sweep

    permfl = PerMFL(port_fns()[0], PerMFLHParams(**HP))
    args = {
        "unknown": (permfl, [dict(k_team=2)], {}, "k_team"),
        "empty_grid": (permfl, [], {}, "empty grid"),
        "empty_seeds": (permfl, [{}], {"seeds": ()}, "empty seeds"),
        "mask_blind": (B.FedAvg(port_fns()[0], lr=0.1, local_steps=2),
                       [dict(lr=0.2)], {"team_frac": 0.5}, "participation"),
        "masks_count": (permfl, [{}], {"masks": [None]}, "2 configs"),
    }[case]
    algo, grid, kw, match = args
    train, val = batches(small_fed_data)
    with pytest.raises(ValueError, match=match):
        run_sweep(algo, grid, kw.pop("seeds", SEEDS), init, train, val,
                  metric_fn=port_fns()[1], rounds=1, m=4, n=3,
                  device="cpu", **kw)


@pytest.mark.parametrize("arg", ["mesh", "trace", "trace_dir"])
def test_unported_sweep_options_raise(arg, small_fed_data, tmp_path):
    """The sweep mesh is ported for one card: a mesh on another device
    than the run's raises, and so does one larger than the card (its
    bit-equality with the unsharded sweep is
    tests/test_torch_sharding.py's); run telemetry is ported, so
    ``trace=`` and ``trace_dir=`` run and give their products."""
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.train.sweep import run_sweep

    if arg == "mesh":
        card = Mesh(("sweep", "data", "model"), (1, 1, 1),
                    torch.device("cuda"))
        with pytest.raises(ValueError, match="mesh"):
            run_sweep(PerMFL(None, PerMFLHParams()), [{}], 0, {}, {}, {},
                      metric_fn=None, rounds=1, m=1, n=1, device="cpu",
                      mesh=card)
        with pytest.raises(ValueError, match="one card"):
            make_host_mesh(n_sweep=2, device="cpu")
        return
    sw = port_sweep(PerMFL(port_fns()[0], PerMFLHParams(**HP)),
                    [dict(lam=0.3)], small_fed_data, 1,
                    **{arg: True if arg == "trace" else str(tmp_path)})
    if arg == "trace":
        assert all(len(r.trace) == 1 and r.health.ok() for r in sw)
    else:
        assert sw.events_path and list(tmp_path.glob("spans-*.trace.json"))


def test_run_multi_sweep_runs_each_variant(small_fed_data):
    from repro_torch.comm import CommConfig
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.train.engine import run_experiment
    from repro_torch.train.sweep import run_multi_sweep

    train, val = batches(small_fed_data)
    variants = [dict(algo=PerMFL(port_fns()[0], PerMFLHParams(**HP),
                                 comm=CommConfig(c)), params0=init,
                     grid=[dict(lam=0.5)], seeds=(3,)) for c in
                ("topk", "sign")]
    out = run_multi_sweep(variants, train, val, metric_fn=port_fns()[1],
                          rounds=1, m=4, n=3, device="cpu")
    assert [len(o) for o in out] == [1, 1]
    for o, v in zip(out, variants):
        _, rebuild = v["algo"].tree_hparams()
        ref = run_experiment(rebuild(dict(lam=0.5)), init(3), train, val,
                             metric_fn=port_fns()[1], rounds=1, m=4, n=3,
                             seed=3, device="cpu")
        assert o.configs[0]["seed"] == 3
        assert_equal_runs(o[0], ref)
    assert out[0][0].comm.total_bytes() != out[1][0].comm.total_bytes()


def test_sweep_scenario_on_fig3(small_fed_data):
    """``fig3/mnist/mclr`` cut to 2 x 3 devices: two grid points x two
    seeds, each equal to its looped run from the same build."""
    from repro_torch.scenarios import build_scenario, get_scenario, \
        sweep_scenario
    from repro_torch.scenarios.spec import init_model
    from repro_torch.train.engine import run_experiment

    s = get_scenario("fig3/mnist/mclr").scaled(m_teams=2, n_devices=3,
                                               samples_per_device=16)
    grid = [dict(beta=0.3), dict(gamma=0.5, lam=0.1)]
    sw = sweep_scenario(s, grid, (0, 1), rounds=2, device="cpu")
    assert len(sw) == 4
    b = build_scenario(s, 0, device="cpu")
    _, rebuild = b.algo.tree_hparams()
    i = 0
    for g in grid:
        for seed in (0, 1):
            ref = run_experiment(rebuild(g), init_model(b.config, seed),
                                 b.train, b.val, metric_fn=b.metric_fn,
                                 rounds=2, m=2, n=3, seed=seed,
                                 device="cpu")
            assert sw.configs[i]["seed"] == seed
            assert_equal_runs(sw[i], ref)
            i += 1


def test_sweep_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.scenarios import sweep_scenario
    from repro_torch.train.sweep import run_sweep

    for call in (lambda: sweep_scenario("fig3/mnist/mclr"),
                 lambda: run_sweep(PerMFL(None, PerMFLHParams()), [{}], 0,
                                   {}, {}, {}, metric_fn=None, rounds=1,
                                   m=1, n=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -------------------------------------------------- the prox step per config

@pytest.mark.parametrize("anchors", ["team", "device", "config"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prox_plain_per_config_equals_scalar_calls(anchors, dtype):
    """``prox_step_`` with (G,) alpha / lam equals G calls with floats, bit
    for bit: the team tier, one anchor per device (pFedMe) and one per
    config (Ditto); and ``prox_sgd_ref`` with (G,) values equals G calls
    on its leading axis."""
    from repro_torch.kernels.prox_update import prox_sgd_ref, prox_step_

    g_, m, n, p = 3, 2, 4, 37
    rows = g_ * m * n
    a_rows = {"team": g_ * m, "device": rows, "config": g_}[anchors]
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)

    theta, grad, anchor = t(rows, p), t(rows, p), t(a_rows, p)
    # float64 values whose float32 casts differ from a short decimal
    alpha64 = np.array([0.01, 0.05, 1 / 3])
    lam64 = np.array([0.5, 1.7, 2 / 3])
    alpha, lam = (torch.from_numpy(v.astype(np.float32))
                  for v in (alpha64, lam64))
    got = theta.clone()
    prox_step_(got, grad, anchor, alpha=alpha, lam=lam)
    want = theta.clone()
    r, q = rows // g_, a_rows // g_
    for i in range(g_):
        prox_step_(want[i * r:(i + 1) * r], grad[i * r:(i + 1) * r],
                   anchor[i * q:(i + 1) * q], alpha=float(alpha64[i]),
                   lam=float(lam64[i]))
    assert torch.equal(got, want)

    new, _ = prox_sgd_ref(theta.view(g_, r, p), grad.view(g_, r, p),
                          theta.view(g_, r, p).flip(-1), alpha=alpha,
                          lam=lam)
    for i in range(g_):
        one, _ = prox_sgd_ref(theta.view(g_, r, p)[i],
                              grad.view(g_, r, p)[i],
                              theta.view(g_, r, p)[i].flip(-1),
                              alpha=float(alpha64[i]), lam=float(lam64[i]))
        assert torch.equal(new[i], one)


def test_prox_step_refuses_bad_groups():
    from repro_torch.kernels.prox_update import prox_step_

    theta, grad = torch.zeros(12, 8), torch.zeros(12, 8)
    two = torch.ones(2)
    with pytest.raises(ValueError, match="do not tile"):
        prox_step_(theta, grad, torch.zeros(3, 8), alpha=two, lam=two)
    with pytest.raises(TypeError, match="both"):
        prox_step_(theta, grad, torch.zeros(4, 8), alpha=two, lam=0.5)
    with pytest.raises(ValueError, match="float32"):
        prox_step_(theta, grad, torch.zeros(4, 8), alpha=two.double(),
                   lam=two.double())
