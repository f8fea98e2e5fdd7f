"""The port's LM trainers on the encoder-decoder and VLM families
(``whisper-small``, ``qwen2-vl-2b``) against the JAX package on the CPU.

Reduced configs, float32: Whisper (2 decoder and 2 encoder layers over 64
frames, d 256, 4 heads of 64, LayerNorm with bias, tanh-GELU, cross
attention) and Qwen2-VL (2 layers, GQA 4:1, QKV biases, M-RoPE,
embeddings in, a separate head, so the ``embed`` leaf is never read and
its gradient is zeros), vocab 512, the reference's ``init_params``
carried across by ``convert.params_from_numpy``. Batches from a numpy
seed with the keys ``tests/test_arch_smoke.py::_reduced_batch`` gives:
Whisper's frame embeddings and tokens; Qwen2-VL's embeddings at an image
prompt's M-RoPE positions (text, a 2 x 4 patch grid, text), its targets
-100 on the grid.

Losses and trees after ``make_train_step`` (sgd, adamw),
``make_permfl_device_step`` and one ``make_tier_round`` (l_local 2)
against the jitted reference within rtol 1e-4 / atol 1e-5, and
``value_and_grad`` leaf by leaf against ``jax.grad``. The gradient norm
is held within 1e-4 of the float64 norm of the reference's gradients.
The jitted reference's own norm is no yardstick on these trees: on
the step's batch it reads 13.23330 (Whisper) and 8.04562 (Qwen2-VL)
against float64 norms of 13.27029 and 8.05219, 2.8e-3 and 8.2e-4 below
them (the effect ``test_torch_train.py`` records on Jamba's tree), past
the 1e-3 the other trees keep; the port's read 13.27027 and 8.05216.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["whisper-small", "qwen2-vl-2b"]
B, S = 2, 16
# Qwen2-VL's prompt: TEXT text rows, a GRID patch grid, the rest text
TEXT, GRID = 4, (2, 4)
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


def _mrope_positions():
    """(S, 3): TEXT rows at (i, i, i), the grid at (TEXT, TEXT + row,
    TEXT + col), the rest resuming after the grid's largest position."""
    rows, cols = GRID
    text = np.arange(TEXT)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    grid = np.stack([np.zeros_like(r), r, c], -1).reshape(-1, 3) + TEXT
    after = np.arange(S - TEXT - rows * cols) + grid.max() + 1
    return np.concatenate([np.repeat(text[:, None], 3, 1), grid,
                           np.repeat(after[:, None], 3, 1)]).astype(np.int32)


def _batch(cfg, seed):
    """One batch of B x S from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = np.broadcast_to(
            _mrope_positions(), (B, S, 3)).copy()
    else:
        batch["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)
    batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)
    if cfg.family == "vlm":
        batch["targets"][:, TEXT:TEXT + GRID[0] * GRID[1]] = -100
    return batch


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, key):
    return JM.init_params(jax.random.PRNGKey(key), j_reduced(arch))


def _models(arch, key=3):
    """(reference config, port config, reference tree, the port's copy);
    the trainers under test never write their inputs."""
    from repro_torch.configs import get_reduced_config

    jp = _ref_tree(arch, key)
    return j_reduced(arch), get_reduced_config(arch), jp, _to_port(jp)


@functools.lru_cache(maxsize=None)
def _ref_grads(arch, seed):
    """(loss, gradients) of the reference's ``loss_fn`` at ``_models(arch)``
    on ``_batch(cfg, seed)``, by ``jax.grad``."""
    jcfg, cfg, jp, _ = _models(arch)
    batch = _jb(_batch(cfg, seed))
    return jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(q, jcfg, batch)))(jp)


def _norm64(grads):
    return np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                       for g in jax.tree.leaves(grads)))


def _close_adam(got, want, m_got, m_want, lr, path=""):
    """AdamW's first step moves each parameter by lr * u(g), u(g) = g /
    (|g| + 1e-8), g = m / (1 - b1): where |g| is within rounding of 1e-8
    the two gradients' rounding decides it. Each parameter within RTOL /
    ATOL, but where lr |u(g_got) - u(g_want)| exceeds ATOL: there within
    the step's size, 2 lr, and its two gradients within ATOL of the
    leaf's largest |g|. ``test_torch_train.py`` excuses every |g| under
    1e-6 if under 1% of a leaf does; 19% of Qwen2-VL's key bias would
    be excused here: its gradient reads 0 but through M-RoPE's slowest
    frequencies (theta 1e6), 1e-9 to 3e-7 on those entries, sums of
    terms ~1e-2 that cancel to within ~1e-8 of each other on both
    sides."""
    if isinstance(want, dict):
        for k in want:
            _close_adam(got[k], want[k], m_got[k], m_want[k], lr,
                        f"{path}/{k}")
        return
    gr = [_np(m) / 0.1 for m in (m_got, m_want)]       # adamw's b1 = 0.9
    u = [x / (np.abs(x) + 1e-8) for x in gr]
    excused = lr * np.abs(u[0] - u[1]) > ATOL
    scale = np.abs(gr[1]).max()
    assert np.abs(gr[0] - gr[1])[excused].max(initial=0.0) <= ATOL * scale, \
        path
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g[~excused], w[~excused], rtol=RTOL,
                               atol=ATOL, err_msg=path)
    assert np.abs(g[excused] - w[excused]).max(initial=0.0) <= 2 * lr, path


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_reads_what_the_family_needs(arch):
    """Whisper's batch carries frames and tokens, Qwen2-VL's embeddings at
    distinct M-RoPE triples with -100 targets on the grid; both trees
    have the leaves the chip phases count (35 and 15 at full width)."""
    from repro_torch.flat import tree_leaves

    jcfg, cfg, jp, p = _models(arch)
    batch = _batch(cfg, 0)
    n = len(tree_leaves(p))
    assert n == len(jax.tree.leaves(jp)) == {"whisper-small": 35,
                                            "qwen2-vl-2b": 15}[arch]
    if cfg.family == "vlm":
        pos = batch["mrope_positions"][0]
        assert len({tuple(r) for r in pos}) == S
        assert (batch["targets"] == -100).sum() == B * GRID[0] * GRID[1]
        assert "tokens" not in batch and not cfg.tie_embeddings
    else:
        assert batch["enc_frames"].shape == (B, cfg.encoder_seq_len,
                                             cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_matches_jax_grad(arch):
    """The loss and every leaf's gradient against ``jax.grad`` of the
    reference's ``loss_fn``; Qwen2-VL's unread ``embed`` gets zeros on
    both sides."""
    from repro_torch.flat import tree_leaves
    from repro_torch.train.trainer import value_and_grad

    jcfg, cfg, jp, p = _models(arch)
    batch = _batch(cfg, 0)
    loss, grads = value_and_grad(p, cfg, _tb(batch))
    jloss, jgrads = _ref_grads(arch, 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    _close_tree(grads, jgrads)
    leaves = [g for _, g in tree_leaves(grads)]
    assert all(bool(torch.isfinite(g).all()) for g in leaves)
    if cfg.family == "vlm":
        assert grads["embed"].dtype == p["embed"].dtype
        assert not grads["embed"].any()
        assert not np.asarray(jgrads["embed"]).any()
        assert grads["lm_head"].abs().sum() > 0
    else:
        assert grads["encoder"]["layers"]["attn"]["wq"].abs().sum() > 0
    np.testing.assert_allclose(
        np.sqrt(sum(float((g.double() ** 2).sum()) for g in leaves)),
        _norm64(jgrads), rtol=RTOL)


@pytest.mark.parametrize("arch,opt_name,clip", [
    (a, o, c) for a in ARCHS for o, c in (("sgd", 1.0), ("adamw", 100.0))])
def test_train_step_matches(arch, opt_name, clip):
    """One step: the loss, the parameters (AdamW's under ``_close_adam``)
    and its moments; the gradient norm within RTOL of the reference
    gradients' float64 norm. SGD with clipping active (the norms are ~13
    and ~6), AdamW with it idle."""
    from repro_torch.train import TrainState
    from repro_torch.train import optim as O
    from repro_torch.train.trainer import make_train_step

    jcfg, cfg, jp, p = _models(arch)
    opt, jopt = getattr(O, opt_name)(), getattr(JOPT, opt_name)()
    lr = 1e-2
    batch = _batch(cfg, 0)
    state, m = make_train_step(cfg, opt, lr=lr, grad_clip=clip)(
        TrainState.create(p, opt), _tb(batch))
    jstate, jm = jax.jit(JTR.make_train_step(jcfg, jopt, lr=lr,
                                             grad_clip=clip))(
        JTrainState.create(jp, jopt), _jb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               _norm64(_ref_grads(arch, 0)[1]),
                               rtol=RTOL)
    assert int(state.step) == int(jstate.step) == 1
    if opt_name == "adamw":
        _close_adam(state.params, jstate.params, state.opt_state["m"],
                    jstate.opt_state["m"], lr)
        _close_tree(state.opt_state["m"], jstate.opt_state["m"])
        _close_tree(state.opt_state["v"], jstate.opt_state["v"])
    else:
        _close_tree(state.params, jstate.params)


@pytest.mark.parametrize("arch", ARCHS)
def test_permfl_device_step_matches(arch):
    from repro_torch.train.trainer import make_permfl_device_step

    jcfg, cfg, jtheta, theta = _models(arch)
    jw = JM.init_params(jax.random.PRNGKey(4), jcfg)
    w = _to_port(jw)
    batch = _batch(cfg, 2)
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
    are left as they are."""
    from repro_torch.train.trainer import make_tier_round

    jcfg, cfg, jx, x = _models(arch)
    jw = JM.init_params(jax.random.PRNGKey(5), jcfg)
    jtheta = JM.init_params(jax.random.PRNGKey(6), jcfg)
    w, theta = _to_port(jw), _to_port(jtheta)
    batch = _batch(cfg, 3)
    got = make_tier_round(cfg, l_local=2, **TIER)(theta, w, x, _tb(batch))
    want = jax.jit(JTR.make_tier_round(jcfg, l_local=2, **TIER))(
        jtheta, jw, jx, _jb(batch))
    np.testing.assert_allclose(float(got[3]["loss"]), float(want[3]["loss"]),
                               rtol=RTOL, atol=ATOL)
    for g, wt in zip(got[:3], want[:3]):
        _close_tree(g, wt)
    for inp, jinp in ((theta, jtheta), (w, jw), (x, jx)):
        _close_tree(inp, jinp, 0, 0)


# ---------------------------------------------------------------------------
# what chip_smoke.py trains on the card (phases 13r, 13s)
# ---------------------------------------------------------------------------

def _chip_smoke():
    """The repository's chip_smoke.py as a module (it imports nothing of
    the card's at import time)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cut", ["full", "consistency"])
def test_chip_smoke_trees_are_the_reference_trees(arch, cut):
    """The trees the chip phases draw at the published widths, whole
    (13r, 13s) and cut for the f32 consistency check: their parameters
    and leaves are the reference tree's (jax.eval_shape), and the port's
    tree has the reference's names, shapes and dtypes (FakeTensorMode:
    nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config
    from repro_torch.flat import tree_leaves
    from repro_torch.models import model as M

    C = _chip_smoke()
    kw = C.ENCDEC_VLM_CONSISTENCY_CUT[arch] if cut == "consistency" else {}
    shapes = jax.eval_shape(functools.partial(
        JM.init_params, cfg=j_config(arch).replace(**kw),
        dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    want = sorted(("/".join(str(p.key) for p in path), tuple(v.shape),
                   str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      shapes)[0])
    n = sum(int(np.prod(s)) for _, s, _ in want)
    assert len(want) == C.ENCDEC_VLM_LEAVES[arch]
    if cut == "full":
        assert n == {"whisper-small": C.WHISPER_PARAMS,
                     "qwen2-vl-2b": C.VLM_PARAMS}[arch]
    else:
        assert n == C.ENCDEC_VLM_CONSISTENCY_PARAMS[arch]
    with FakeTensorMode():
        mine = M.init_params(0, get_config(arch).replace(**kw),
                             dtype=torch.bfloat16, device="cpu")
        got = sorted(("/".join(k), tuple(v.shape),
                      str(v.dtype).replace("torch.", ""))
                     for k, v in tree_leaves(mine))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_batches(arch, monkeypatch):
    """``chip_smoke.model_batches`` at the published widths (built on the
    CPU here): Whisper's 4 x 448 tokens over 4 x 1,500 frame embeddings,
    Qwen2-VL's 4 x 1,024 embeddings at an image prompt's distinct M-RoPE
    triples in place of tokens, -100 targets on its 896 grid positions;
    the targets the token stream's, in the vocabulary."""
    from repro_torch.configs import get_config

    C = _chip_smoke()
    monkeypatch.setattr(C, "DEVICE", "cpu")
    cfg = get_config(arch)
    (b,) = C.model_batches(cfg, 1, torch.bfloat16)
    grid = C.VLM_GRID[0] * C.VLM_GRID[1]
    if cfg.family == "vlm":
        assert set(b) == {"embeds", "mrope_positions", "targets"}
        assert b["embeds"].shape == (4, 1024, 1536)
        assert b["embeds"].dtype == torch.bfloat16
        pos = b["mrope_positions"]
        assert pos.shape == (4, 1024, 3) and pos.dtype == torch.int32
        assert len({tuple(r) for r in pos[0].tolist()}) == 1024
        t = b["targets"]
        assert bool((t[:, C.VLM_TEXT:C.VLM_TEXT + grid] == -100).all())
        t = torch.cat([t[:, :C.VLM_TEXT], t[:, C.VLM_TEXT + grid:]], 1)
    else:
        assert set(b) == {"tokens", "targets", "enc_frames"}
        assert b["tokens"].shape == b["targets"].shape == (4, 448)
        assert b["enc_frames"].shape == (4, 1500, 768)
        assert b["enc_frames"].dtype == torch.bfloat16
        t = b["targets"]
    assert bool(((t >= 0) & (t < cfg.vocab_size)).all())
