"""The port's LM training (``repro_torch.train.{trainer, optim,
train_state, metrics}``, ``repro_torch.data.tokens``,
``prox_update.prox_sgd_tree``) against the JAX package on the CPU.

Reduced configs: ``phi3-mini-3.8b`` (2 layers, d 256, 4 heads of 64,
vocab 512), ``qwen3-14b`` (GQA 4:1 and qk-norm), ``deepseek-moe-16b``
(the MoE router's gradient, the aux loss of every MoE layer, which ends
each block as in the reference), ``rwkv6-7b`` (the WKV-6 scan's
gradient) and ``jamba-1.5-large-398b`` (Mamba's selective scan's
gradient; its MoE layers end their blocks too), the reference's
``init_params`` carried across, batches from ``tokens.lm_batches``.
Float32 throughout. Losses and parameters after ``make_train_step`` (sgd,
momentum, adamw), ``make_permfl_device_step`` and one ``make_tier_round``
(l_local 2) against the jitted reference within rtol 1e-4 / atol 1e-5,
the optimizer states likewise. The reference differentiates its XLA
attention, router and WKV scan (``jax.grad``); the port its plain
backward versions (``attention_bwd_ref``, ``route_tokens_bwd_ref``,
``wkv6_bwd_ref``, ``scan_bwd_ref``), so they agree to float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.data import tokens as JTOK  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import metrics as JMET  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["phi3-mini-3.8b", "qwen3-14b", "deepseek-moe-16b", "rwkv6-7b",
         "jamba-1.5-large-398b"]
B, S, VOCAB = 2, 16, 512
# the example's tier hyperparameters
TIER = dict(alpha=3e-3, lam=0.5, gamma=1.5, eta=0.03, beta=0.3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_port(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _close_tree(got, want, rtol=RTOL, atol=ATOL, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=path)


def _batch(seed=0, steps=1):
    rng = np.random.default_rng(seed)
    return list(JTOK.lm_batches(rng, VOCAB, batch=B, seq_len=S, steps=steps))


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _models(arch):
    from repro_torch.configs import get_reduced_config

    jcfg = j_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, get_reduced_config(arch), jp, _to_port(jp)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_tokens_bit_equal():
    from repro_torch.data import tokens as T

    for topic in (0, 3):
        a = T.zipf_bigram_stream(np.random.default_rng(7), 300, 2000,
                                 topic=topic)
        b = JTOK.zipf_bigram_stream(np.random.default_rng(7), 300, 2000,
                                    topic=topic)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    got = list(T.lm_batches(np.random.default_rng(1), VOCAB, batch=3,
                            seq_len=20, steps=4, topic=2))
    want = list(JTOK.lm_batches(np.random.default_rng(1), VOCAB, batch=3,
                                seq_len=20, steps=4, topic=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("tokens", "targets"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    got = T.federated_lm_data(np.random.default_rng(2), 256, m_teams=2,
                              n_devices=3, seq_len=12, seqs_per_device=4)
    want = JTOK.federated_lm_data(np.random.default_rng(2), 256, m_teams=2,
                                  n_devices=3, seq_len=12, seqs_per_device=4)
    for k in ("tokens", "targets"):
        assert got[k].shape == (2, 3, 4, 12)
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((4, 6)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * scale).astype(np.float32),
                  "d": np.zeros(3, np.float32)}}


OPTS = {"sgd": ({}, {}), "momentum": ({"mu": 0.8}, {}),
        "nesterov": ({"mu": 0.8, "nesterov": True}, {}),
        "adamw": ({}, {}), "adamw_wd": ({"weight_decay": 0.1,
                                         "b2": 0.99}, {})}


def _opt_pair(name, kw):
    from repro_torch.train import optim as O

    ctor = "momentum" if name == "nesterov" else name.split("_")[0]
    return getattr(O, ctor)(**kw), getattr(JOPT, ctor)(**kw)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_update_matches(name):
    """Two updates in a row: updates and states as the reference's."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    opt, jopt = _opt_pair(name, OPTS[name][0])
    p, jp = _to_port(params), jax.tree.map(jnp.asarray, params)
    state, jstate = opt.init(p), jopt.init(jp)
    for step in range(2):
        grads = _tree(rng, 0.5)
        upd, state = opt.update(_to_port(grads), state, p, 0.05)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                   jp, 0.05)
        _close_tree(upd, jupd, 1e-5, 1e-7)
        if name.startswith("adamw"):
            _close_tree({"m": state["m"], "v": state["v"]},
                        {"m": jstate["m"], "v": jstate["v"]}, 1e-6, 1e-8)
            assert int(state["t"]) == int(jstate["t"]) == step + 1
            assert state["t"].dtype == torch.int32
        elif name != "sgd":
            _close_tree(state, jstate, 1e-6, 1e-8)
        else:
            assert state == () == jstate


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches(max_norm):
    from repro_torch.train.optim import clip_by_global_norm, global_norm

    grads = _tree(np.random.default_rng(1))
    got, norm = clip_by_global_norm(_to_port(grads), max_norm)
    want, jnorm = JOPT.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(_to_port(grads))),
                               float(JOPT.global_norm(grads)), rtol=1e-6)
    _close_tree(got, want, 1e-6, 1e-8)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

# (arch, optimizer, grad_clip): clipping is active at 1.0 (the norm is
# ~20) and idle at 100. rwkv6-7b takes momentum, not AdamW: its decay_A
# leaf's gradient is mostly under ADAM_FLAT (decay_B starts at scale
# 0.01), so AdamW's first step there is rounding noise on most of the
# leaf, which _close_adam's 1% rule refuses, as it should
STEP_CASES = [("phi3-mini-3.8b", "sgd", 1.0), ("phi3-mini-3.8b", "sgd", 100.0),
              ("phi3-mini-3.8b", "momentum", 100.0),
              ("phi3-mini-3.8b", "adamw", 100.0), ("qwen3-14b", "adamw", 100.0),
              ("deepseek-moe-16b", "adamw", 100.0),
              ("rwkv6-7b", "momentum", 100.0)]
ADAM_FLAT = 1e-6      # |grad| under which AdamW's first update is noise


def _close_adam(got, want, grads, lr, path=""):
    """AdamW's first step moves each parameter by lr * g / (|g| + eps):
    where |g| is within rounding of eps (1e-8) the sign of a difference
    of rounding errors decides it. Parameters whose reference gradient
    is 0 (an embedding row the batch does not read) or at least
    ADAM_FLAT are held to RTOL / ATOL, the others (under 1% of a leaf)
    only to the step's size, 2 * lr."""
    if isinstance(want, dict):
        for k in want:
            _close_adam(got[k], want[k], grads[k], lr, f"{path}/{k}")
        return
    g, w, gr = _np(got), _np(want), np.abs(_np(grads))
    flat = (gr > 0) & (gr < ADAM_FLAT)
    assert flat.mean() < 1e-2, path
    np.testing.assert_allclose(g[~flat], w[~flat], rtol=RTOL, atol=ATOL,
                               err_msg=path)
    assert np.abs(g[flat] - w[flat]).max(initial=0.0) <= 2 * lr, path


@pytest.mark.parametrize("arch,opt_name,clip", STEP_CASES)
def test_train_step_matches(arch, opt_name, clip):
    from repro_torch.train import TrainState
    from repro_torch.train.trainer import make_train_step

    jcfg, cfg, jp, p = _models(arch)
    opt, jopt = _opt_pair(opt_name, {})
    lr = 1e-2
    (batch,) = _batch()
    step = make_train_step(cfg, opt, lr=lr, grad_clip=clip)
    jstep = jax.jit(JTR.make_train_step(jcfg, jopt, lr=lr, grad_clip=clip))
    state, m = step(TrainState.create(p, opt), _tb(batch))
    jstate, jm = jstep(JTrainState.create(jp, jopt), _jb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    # the gradient norm: within RTOL of the reference's gradients' norm
    # taken in float64; the jitted reference's own (a jitted vdot on the
    # CPU) reads up to ~5e-4 away from that, so it is held to 1e-3 (and
    # the optimizers with state run with clipping idle, where that error
    # would enter their state)
    jgrads = jax.grad(lambda q: JM.loss_fn(q, jcfg, _jb(batch)))(jp)
    norm64 = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                         for g in jax.tree.leaves(jgrads)))
    np.testing.assert_allclose(float(m["grad_norm"]), norm64, rtol=RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert int(state.step) == int(jstate.step) == 1
    if opt_name == "adamw":
        _close_adam(state.params, jstate.params, jgrads, lr)
        _close_tree(state.opt_state["m"], jstate.opt_state["m"])
        _close_tree(state.opt_state["v"], jstate.opt_state["v"])
    else:
        _close_tree(state.params, jstate.params)
    if opt_name == "momentum":
        _close_tree(state.opt_state, jstate.opt_state)


def test_jamba_train_step_matches():
    """The reduced Jamba's momentum step (clipping idle; momentum, not
    AdamW, as rwkv6-7b: a third of its A_log gradient lies under
    ADAM_FLAT): the loss, the parameters and the optimizer state as in
    ``test_train_step_matches``, and the gradient norm within RTOL of the
    float64 norm of the reference's gradients. The jitted reference's own
    norm is no yardstick here: on Jamba's tree it reads 1.8e-3 below that
    float64 norm (44.6808 against 44.7627; its jitted and eager gradients
    agree within 2.3e-6 of each leaf's scale), past the 1e-3 the other
    trees keep."""
    from repro_torch.train import TrainState
    from repro_torch.train.trainer import make_train_step

    jcfg, cfg, jp, p = _models("jamba-1.5-large-398b")
    opt, jopt = _opt_pair("momentum", {})
    lr = 1e-2
    (batch,) = _batch()
    step = make_train_step(cfg, opt, lr=lr, grad_clip=100.0)
    jstep = jax.jit(JTR.make_train_step(jcfg, jopt, lr=lr, grad_clip=100.0))
    state, m = step(TrainState.create(p, opt), _tb(batch))
    jstate, jm = jstep(JTrainState.create(jp, jopt), _jb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    jgrads = jax.jit(jax.grad(lambda q: JM.loss_fn(q, jcfg, _jb(batch))))(
        jp)
    norm64 = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                         for g in jax.tree.leaves(jgrads)))
    np.testing.assert_allclose(float(m["grad_norm"]), norm64, rtol=RTOL)
    assert int(state.step) == int(jstate.step) == 1
    _close_tree(state.params, jstate.params)
    _close_tree(state.opt_state, jstate.opt_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_permfl_device_step_matches(arch):
    from repro_torch.train.trainer import make_permfl_device_step

    jcfg, cfg, jtheta, theta = _models(arch)
    jw = JM.init_params(jax.random.PRNGKey(4), jcfg)
    w = _to_port(jw)
    (batch,) = _batch(1)
    got, m = make_permfl_device_step(cfg, alpha=0.05, lam=0.5)(
        theta, w, _tb(batch))
    want, jm = jax.jit(JTR.make_permfl_device_step(jcfg, alpha=0.05,
                                                   lam=0.5))(
        jtheta, jw, _jb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    _close_tree(got, want)
    _close_tree(theta, jtheta, 0, 0)          # the input is left as it is


@pytest.mark.parametrize("arch", ARCHS)
def test_tier_round_matches(arch):
    """One round, l_local 2: theta', w', x' and the mean loss; the inputs
    (x shared by every team) are left as they are."""
    from repro_torch.train.trainer import make_tier_round

    jcfg, cfg, jx, x = _models(arch)
    jw = JM.init_params(jax.random.PRNGKey(5), jcfg)
    jtheta = JM.init_params(jax.random.PRNGKey(6), jcfg)
    w, theta = _to_port(jw), _to_port(jtheta)
    (batch,) = _batch(2)
    got = make_tier_round(cfg, l_local=2, **TIER)(theta, w, x, _tb(batch))
    want = jax.jit(JTR.make_tier_round(jcfg, l_local=2, **TIER))(
        jtheta, jw, jx, _jb(batch))
    np.testing.assert_allclose(float(got[3]["loss"]), float(want[3]["loss"]),
                               rtol=RTOL, atol=ATOL)
    for g, wt in zip(got[:3], want[:3]):
        _close_tree(g, wt)
    for inp, jinp in ((theta, jtheta), (w, jw), (x, jx)):
        _close_tree(inp, jinp, 0, 0)


def test_tier_round_remat_equals_plain():
    """remat=True (torch.utils.checkpoint per block) gives the same round."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.train.trainer import make_tier_round

    cfg = get_reduced_config("phi3-mini-3.8b")
    x = M.init_params(0, cfg, device="cpu")
    (batch,) = _batch(3)
    a = make_tier_round(cfg, l_local=2, **TIER)(x, x, x, _tb(batch))
    b = make_tier_round(cfg, l_local=2, remat=True, **TIER)(
        x, x, x, _tb(batch))
    assert float(a[3]["loss"]) == float(b[3]["loss"])
    for ta, tb in zip(a[:3], b[:3]):
        _close_tree(ta, tb, 1e-6, 1e-7)


def test_prox_sgd_tree_matches_and_zero_momentum_is_stride_0():
    from repro_torch.kernels.prox_update import prox_sgd_tree
    from repro.kernels.prox_update.ops import prox_sgd_tree as j_prox

    rng = np.random.default_rng(4)
    t, g, a = _tree(rng), _tree(rng), _tree(rng)
    for mom in (0.0, 0.9):
        m0 = None if mom == 0.0 else _tree(rng)
        got, gm = prox_sgd_tree(_to_port(t), _to_port(g), _to_port(a),
                                None if m0 is None else _to_port(m0),
                                alpha=0.1, lam=0.5, momentum=mom)
        want, wm = j_prox(*(jax.tree.map(jnp.asarray, z) for z in (t, g, a)),
                          None if m0 is None else jax.tree.map(jnp.asarray,
                                                               m0),
                          alpha=0.1, lam=0.5, momentum=mom, mode="xla")
        _close_tree(got, want, 1e-6, 1e-7)
        _close_tree(gm, wm, 1e-6, 1e-7)
        if mom == 0.0:
            assert gm["a"].stride() == (0, 0)


def test_train_loop_history_matches():
    from repro_torch.train import optim as O
    from repro_torch.train.trainer import train_loop

    jcfg, cfg, jp, p = _models("phi3-mini-3.8b")
    batches = _batch(5, steps=4)
    kw = dict(lr=1e-2, steps=4, log_every=2, seed=3)
    _, hist = train_loop(cfg, iter(batches), opt=O.adamw(), params=p,
                         device="cpu", **kw)
    _, jhist = JTR.train_loop(jcfg, iter(batches), opt=JOPT.adamw(), **kw)
    assert [i for i, _ in hist] == [i for i, _ in jhist] == [0, 2, 3]
    np.testing.assert_allclose([v for _, v in hist], [v for _, v in jhist],
                               rtol=RTOL, atol=ATOL)
    assert hist[-1][1] < hist[0][1]


def test_train_state_crosses_both_ways():
    from repro_torch.convert import to_numpy, train_state_from_numpy
    from repro_torch.train import optim as O
    from repro_torch.train.trainer import make_train_step

    jcfg, cfg, jp, p = _models("phi3-mini-3.8b")
    (batch,) = _batch(6)
    jstate, _ = jax.jit(JTR.make_train_step(jcfg, JOPT.adamw()))(
        JTrainState.create(jp, JOPT.adamw()), _jb(batch))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert int(state.step) == 1 and state.opt_state["t"].dtype == torch.int32
    back = to_numpy(state)
    _close_tree(back["params"], jstate.params, 0, 0)
    _close_tree(back["opt_state"]["m"], jstate.opt_state["m"], 0, 0)
    # a second step continues the reference's trajectory
    state, m = make_train_step(cfg, O.adamw())(state, _tb(batch))
    jstate, jm = jax.jit(JTR.make_train_step(jcfg, JOPT.adamw()))(
        jstate, _jb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    _close_tree(state.params, jstate.params)
    sgd = train_state_from_numpy({"params": jp, "opt_state": (), "step": 0})
    assert sgd.opt_state == () and to_numpy(sgd)["opt_state"] == ()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_match():
    from repro_torch.train.metrics import (RunningMean, perplexity,
                                           token_accuracy)

    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    targets = rng.integers(-1, 11, size=(3, 7)).astype(np.int32)
    got = token_accuracy(torch.from_numpy(logits),
                         torch.from_numpy(targets).long())
    want = JMET.token_accuracy(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
    pad = torch.full((3, 7), -100)
    assert float(token_accuracy(torch.from_numpy(logits), pad)) == 0.0
    np.testing.assert_allclose(float(perplexity(torch.tensor(2.5))),
                               float(JMET.perplexity(2.5)), rtol=1e-6)
    rm, jrm = RunningMean(), JMET.RunningMean()
    assert rm.mean == jrm.mean == 0.0
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 3)):
        rm.update(v, n)
        jrm.update(v, n)
    assert rm.mean == jrm.mean
    for bad in (0, -1):
        with pytest.raises(ValueError):
            rm.update(1.0, bad)
    with pytest.raises(TypeError):
        rm.update(1.0, 1.5)
    rm.reset()
    assert rm.mean == 0.0 and rm.count == 0


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_tiered_llm_example_on_cpu(capsys):
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "tiered_llm_training_torch.py")
    spec = importlib.util.spec_from_file_location("tiered_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pm, gm = mod.main(["--device", "cpu", "--rounds", "3"])
    assert pm <= gm and np.isfinite(pm)
    out = capsys.readouterr().out
    assert "round   2: personalized loss" in out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-7b",
                                  "jamba-1.5-large-398b", "qwen2-vl-2b"])
def test_tiered_llm_example_on_cpu_moe_and_rwkv(arch, capsys):
    """The example trains the reduced MoE, RWKV-6, Jamba and Qwen2-VL
    models too (the router's, the WKV scan's and the selective scan's
    plain backward; Qwen2-VL on tokens alone, as the reference's example
    runs it), 3 rounds."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "tiered_llm_training_torch.py")
    spec = importlib.util.spec_from_file_location("tiered_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pm, gm = mod.main(["--device", "cpu", "--rounds", "3", "--arch", arch])
    assert pm <= gm and np.isfinite(pm)
    assert "round   2: personalized loss" in capsys.readouterr().out
