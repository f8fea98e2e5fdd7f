"""Training through the port's Mamba mixer (``repro_torch.models.mamba``,
``repro_torch.kernels.mamba_scan``) against the JAX package on the CPU,
where the selective scan runs its plain versions (``scan_ref`` forward,
``scan_bwd_ref`` backward, from snapshots every ``segment`` steps).

Reduced widths: jamba-1.5-large-398b's reduced mixer (d_model 256, so
d_in 512, d_state 16, d_conv 4), batch 2, inputs from numpy seeds, the
reference's parameters carried across.

* Every mixer leaf's gradient and dx against ``jax.vjp`` of
  ``repro.models.mamba.mamba_apply`` at s = 1, 17, 64 and 130 (ragged,
  crossing segments), float32: within 1e-6 of each leaf's largest value
  plus 1e-5 of each value (sums in other orders).
* With a cache (prefill semantics): the gradients of the conv window and
  the initial state (dh0), given cotangents of y, the new window and the
  final state.
* bfloat16 parameters and input, with the reference's silu and softplus
  made to round once as PyTorch's do (as
  ``tests/test_torch_mamba.py::test_bf16_scan_keeps_the_precision_split``
  does): every gradient within ``BF16_GRAD_TOL`` of its leaf's largest
  value (bf16 products rounding in other places).
* ``scan_bwd_ref`` against autograd of an out-of-place scan written here,
  with and without a final-state cotangent, at two segment lengths.
* The reduced Jamba's ``loss_fn`` value and gradient against
  ``jax.value_and_grad`` (its MoE layers end their blocks, so the two aux
  rules agree; ROADMAP.md queue 3), 1e-4 / 1e-5.
* The autograd function asks its backward only for what autograd needs,
  and the CUDA wrappers launch their kernels or raise (build failure,
  launch failure), with nothing in their place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402

ARCH = "jamba-1.5-large-398b"
B = 2
RTOL, ATOL = 1e-5, 1e-6            # of each value, of each leaf's scale
# bf16 gradients: the products of the mixer (in_proj, x_proj, dt_proj,
# out_proj and their transposes) round to bf16 in both packages, in other
# places and orders; measured gaps up to 1.3e-2 of a leaf's scale (D,
# conv_b, dt_bias: sums over bf16 terms; A_log's 4.4e-3, from bf16 terms
# the jitted reference fuses)
BF16_GRAD_TOL = 2e-2
LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
          "A_log", "D", "out_proj")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_scaled(got, want, rtol=RTOL, atol=ATOL, msg=""):
    """``got`` within ``atol`` of ``want``'s largest |value| plus ``rtol``
    of each value; an all-zero ``want`` (A_log's gradient at s = 1 from a
    zero state) must be matched exactly."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, msg
    scale = float(np.abs(w).max())
    err = np.abs(g - w)
    assert (err <= atol * scale + rtol * np.abs(w)).all(), (
        f"{msg}: max err {err.max():.3g}, scale {scale:.3g}")


def _cfg():
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(ARCH)


def _to_port(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _x(s, seed):
    return (np.random.default_rng(seed).standard_normal(
        (B, s, j_reduced(ARCH).d_model)) * 0.3).astype(np.float32)


def _dims():
    cfg = j_reduced(ARCH)
    return cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state


def _port_grads(tp, x, cotangent, cache=None, cache_cot=None):
    """The port's mixer, differentiated: (grads of the leaves, dx, and the
    gradients of the cache's window and state when given)."""
    from repro_torch.models import mamba

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).to(tp["in_proj"].dtype).requires_grad_()
    tc, c_in = None, None
    if cache is not None:
        c_in = {k: torch.from_numpy(v.copy()).requires_grad_()
                for k, v in cache.items()}
        # the mixer writes its cache in place: give it copies
        tc = {k: v.clone() for k, v in c_in.items()}
    y, c = mamba.mamba_apply(leaves, _cfg(), tx, cache=tc)
    loss = (y.float() * torch.from_numpy(cotangent)).sum()
    if cache is not None:
        loss = loss + sum((c[k].float() * torch.from_numpy(cache_cot[k])).sum()
                          for k in cache_cot)
    loss.backward()
    out = {k: v.grad for k, v in leaves.items()}
    out["x"] = tx.grad
    if cache is not None:
        out.update({f"cache_{k}": v.grad for k, v in c_in.items()})
    return out


# ---------------------------------------------------------------------------
# the mixer against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 17, 64, 130])
def test_mixer_gradients_match_jax_vjp(s):
    jcfg = j_reduced(ARCH)
    jp = JMB.mamba_init(jax.random.PRNGKey(0), jcfg)
    x = _x(s, seed=s)
    dy = np.random.default_rng(100 + s).standard_normal(x.shape).astype(
        np.float32)

    @jax.jit
    def vjp(p, xx, ct):
        _, back = jax.vjp(lambda q, z: JMB.mamba_apply(q, jcfg, z)[0], p, xx)
        return back(ct)

    jgp, jgx = vjp(jp, jnp.asarray(x), jnp.asarray(dy))
    got = _port_grads(_to_port(jp), x, dy)
    for k in LEAVES:
        _close_scaled(got[k], jgp[k], msg=f"s {s} d{k}")
    _close_scaled(got["x"], jgx, msg=f"s {s} dx")
    assert float(got["A_log"].abs().max()) > 0 or s == 1


def test_cached_mixer_gradients_match_jax_vjp():
    """A prefill of 70 steps from a nonzero cache, with cotangents of y,
    the new conv window and the final state: every leaf, dx, and the
    gradients of the window and of the initial state (dh0)."""
    jcfg = j_reduced(ARCH)
    d_in, n = _dims()
    jp = JMB.mamba_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    x = _x(70, seed=8)
    cache = {"conv": (rng.standard_normal((B, 3, d_in)) * 0.3)
             .astype(np.float32),
             "ssm": (rng.standard_normal((B, d_in, n)) * 0.1)
             .astype(np.float32)}
    dy = rng.standard_normal(x.shape).astype(np.float32)
    cot = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in cache.items()}

    @jax.jit
    def vjp(p, xx, c, ct_y, ct_c):
        _, back = jax.vjp(lambda q, z, cc: JMB.mamba_apply(q, jcfg, z, cc),
                          p, xx, c)
        return back((ct_y, ct_c))

    jgp, jgx, jgc = vjp(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                        jnp.asarray(dy), jax.tree.map(jnp.asarray, cot))
    got = _port_grads(_to_port(jp), x, dy, cache, cot)
    for k in LEAVES:
        _close_scaled(got[k], jgp[k], msg=f"d{k}")
    _close_scaled(got["x"], jgx, msg="dx")
    _close_scaled(got["cache_conv"], jgc["conv"], msg="dconv")
    _close_scaled(got["cache_ssm"], jgc["ssm"], msg="dh0")
    assert float(got["cache_ssm"].abs().max()) > 0


def _once(fn):
    """``fn`` computed in float32 and rounded once to its input's type, as
    PyTorch's bf16 ``silu`` and ``softplus`` are."""
    return lambda v: fn(v.astype(jnp.float32)).astype(v.dtype)


def test_bf16_mixer_gradients_match_jax(monkeypatch):
    """bf16 parameters (A_log, D, dt_bias float32) and input, 33 steps,
    the reference's silu and softplus rounding once: each gradient within
    BF16_GRAD_TOL of its leaf's largest value, and of the same type as its
    leaf."""
    monkeypatch.setattr(jax.nn, "silu", _once(jax.nn.silu))
    monkeypatch.setattr(jax.nn, "softplus", _once(jax.nn.softplus))
    jcfg = j_reduced(ARCH)
    jp = JMB.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    x = _x(33, seed=9)
    dy = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)

    def f(p, z):
        return JMB.mamba_apply(p, jcfg, z)[0].astype(jnp.float32)

    @jax.jit
    def vjp(p, z, ct):
        return jax.vjp(f, p, z)[1](ct)

    jgp, jgx = vjp(jp, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dy))
    tp = _to_port(jp)
    got = _port_grads(tp, x, dy)
    for k in LEAVES:
        assert got[k].dtype == tp[k].dtype, k
        _close_scaled(got[k], jgp[k], 0.0, BF16_GRAD_TOL, msg=f"bf16 d{k}")
    assert got["x"].dtype == torch.bfloat16
    _close_scaled(got["x"], jgx, 0.0, BF16_GRAD_TOL, msg="bf16 dx")


# ---------------------------------------------------------------------------
# the plain backward against autograd
# ---------------------------------------------------------------------------

def _scan_inputs(s, seed, dtype=torch.float32, d_in=24):
    """xc, dt (softplus of a normal, about 0.7), B and C as strided views
    of one (b, s, 4 + 2N) projection, A = -(1..N) per row, h0 nonzero."""
    n = 16
    rng = np.random.default_rng(seed)
    xc = torch.from_numpy(rng.standard_normal((B, s, d_in)).astype(
        np.float32)).to(dtype)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, s, d_in)).astype(np.float32))).to(dtype)
    proj = torch.from_numpy(rng.standard_normal((B, s, 4 + 2 * n)).astype(
        np.float32)).to(dtype)
    _, b_mat, c_mat = proj.split([4, n, n], dim=-1)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(d_in, n) \
        * torch.from_numpy(rng.uniform(0.5, 1.5, (d_in, 1)).astype(
            np.float32))
    h0 = torch.from_numpy((rng.standard_normal((B, d_in, n)) * 0.5).astype(
        np.float32))
    return xc, dt, b_mat, c_mat, a.contiguous(), h0


def _oop_scan(xc, dt, b_mat, c_mat, a, h0):
    """The scan out of place, one step at a time, for autograd."""
    h, ys = h0, []
    for t in range(xc.shape[1]):
        dtf = dt[:, t].float()
        da = torch.exp(dtf[..., None] * a)
        h = da * h + (dtf * xc[:, t].float())[..., None] \
            * b_mat[:, t].float()[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_mat[:, t].float()))
    return torch.stack(ys, 1).to(xc.dtype), h


@pytest.mark.parametrize("s,segment,final", [
    (1, 64, False), (17, 64, True), (130, 64, True), (130, 16, False),
    (64, 16, True), (130, 8, True), (17, 8, False)])
def test_scan_bwd_ref_matches_autograd_of_an_out_of_place_scan(
        s, segment, final):
    from repro_torch.kernels.mamba_scan import scan_bwd_ref, scan_ref

    xc, dt, b_mat, c_mat, a, h0 = _scan_inputs(s, seed=s + segment)
    leaves = [v.detach().clone().requires_grad_()
              for v in (xc, dt, b_mat, c_mat, a, h0)]
    y, h = _oop_scan(*leaves)
    rng = np.random.default_rng(3)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dh = (torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
          if final else None)
    ((y * dy).sum() + ((h * dh).sum() if final else 0.0)).backward()
    # the forward: y, the final state, each snapshot the state before its
    # segment's first step
    y_r, h_r, snaps = scan_ref(xc, dt, b_mat, c_mat, a, h0, segment=segment,
                               snapshots=True)
    assert snaps.shape == (B, -(-s // segment), 24, 16)
    torch.testing.assert_close(snaps[:, 0], h0, rtol=0, atol=0)
    _close_scaled(y_r, y, msg="y")
    _close_scaled(h_r, h, msg="h")
    got = scan_bwd_ref(xc, dt, b_mat, c_mat, a, h0, dy, dh, snaps=snaps,
                       segment=segment, want_dh0=True)
    for name, g, leaf in zip(("dxc", "ddt", "dB", "dC", "dA", "dh0"), got,
                             leaves):
        assert g.dtype == leaf.dtype and g.is_contiguous(), name
        _close_scaled(g, leaf.grad, msg=name)
    again = scan_bwd_ref(xc, dt, b_mat, c_mat, a, h0, dy, dh,
                         segment=segment)
    assert again[5] is None
    for g, w in zip(again[:5], got[:5]):
        assert torch.equal(g, w)


def test_scan_bwd_ref_in_bf16_rounds_each_gradient_once():
    """bf16 xc, dt, B, C: the gradients in bf16, each the float32 gradient
    of the same inputs rounded once."""
    from repro_torch.kernels.mamba_scan import scan_bwd_ref

    args = _scan_inputs(40, seed=4, dtype=torch.bfloat16)
    dy = torch.randn(B, 40, 24, generator=torch.Generator().manual_seed(0))
    got = scan_bwd_ref(*args, dy.to(torch.bfloat16), segment=16)
    f32 = [v.float() if v.dtype == torch.bfloat16 else v for v in args]
    want = scan_bwd_ref(*f32, dy.to(torch.bfloat16).float(), segment=16)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))
    assert got[4].dtype == torch.float32 and torch.equal(got[4], want[4])


# ---------------------------------------------------------------------------
# the reduced Jamba's loss
# ---------------------------------------------------------------------------

def test_jamba_loss_value_and_grad_match_jax():
    """loss_fn(...).backward() of the reduced Jamba ([(mamba, dense),
    (attn, MoE)] x 4) from the reference's parameters: the loss equals
    jax.value_and_grad's, every gradient is finite and equals the
    reference's, and every Mamba leaf gets one."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.tokens import lm_batches
    from repro_torch.flat import tree_leaves
    from repro_torch.models import model as M

    jcfg = j_reduced(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = next(lm_batches(np.random.default_rng(0), 512, batch=2,
                            seq_len=16, steps=1))
    leaves = [x.requires_grad_() for _, x in tree_leaves(p)]
    loss = M.loss_fn(p, _cfg(), {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    loss.backward()
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(q, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})))(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    names = [name for name, _ in tree_leaves(p)]
    for name, leaf in zip(names, leaves):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
        np.testing.assert_allclose(_np(leaf.grad), want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    mamba_leaves = [leaf for name, leaf in zip(names, leaves)
                    if "mamba" in name]
    assert len(mamba_leaves) == len(LEAVES)
    assert all(float(x.grad.abs().max()) > 0 for x in mamba_leaves)


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


@pytest.mark.parametrize("layers", [2, 3, 4])
def test_jamba_training_cuts_match_the_reference_tree(layers):
    """The training cuts chip_smoke.py and scripts/train_cut.py draw at
    the published widths (``jamba_cut``: one attention layer, the rest
    Mamba, dense FFNs): their parameters and leaves (``jamba_tree``) are
    the reference tree's (jax.eval_shape), and the port's tree has the
    reference's names, shapes and dtypes (FakeTensorMode: nothing
    allocated)."""
    import functools

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config
    from repro_torch.flat import tree_leaves
    from repro_torch.models import model as M

    C = _chip_smoke()
    cut = C.jamba_cut(layers)
    jcfg = j_config(ARCH).replace(**cut)
    assert jcfg.layer_kinds().count("attn") == 1
    assert not any(jcfg.moe_layer_mask())
    shapes = jax.eval_shape(functools.partial(
        JM.init_params, cfg=jcfg, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    want = sorted(("/".join(str(p.key) for p in path), tuple(v.shape),
                   str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      shapes)[0])
    assert (sum(int(np.prod(s)) for _, s, _ in want), len(want)) == \
        C.jamba_tree(layers)
    with FakeTensorMode():
        mine = M.init_params(0, get_config(ARCH).replace(**cut),
                             dtype=torch.bfloat16, device="cpu")
        got = sorted(("/".join(k), tuple(v.shape),
                      str(v.dtype).replace("torch.", ""))
                     for k, v in tree_leaves(mine))
    assert got == want


# ---------------------------------------------------------------------------
# the autograd function and the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["xc", "dt", "b_mat", "a", "h0"])
def test_scan_function_asks_only_for_what_it_needs(which, monkeypatch):
    """Only ``which`` requires a gradient: the backward gets it, dh0 is
    computed only when h0 asks for it, and the gradients of the rest are
    None; scan_bwd runs once."""
    from repro_torch.kernels.mamba_scan import ops

    names = ("xc", "dt", "b_mat", "c_mat", "a", "h0")
    args = list(_scan_inputs(20, seed=5))
    i = names.index(which)
    args[i] = args[i].detach().clone().requires_grad_()
    calls = []
    real = ops.scan_bwd

    def spy(*a, **kw):
        calls.append(kw["want_dh0"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "scan_bwd", spy)
    y, h = ops.scan(*args, segment=8)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y.float().sum() + h.sum()), args[i])
    assert calls == [which == "h0"]
    assert grads[0].shape == args[i].shape

    class Ctx:
        needs_input_grad = tuple(n == which for n in names) + (False,) * 3
        saved_tensors = (*[v.detach() for v in args[:5]],
                         ops.scan_ref(*[v.detach() for v in args], segment=8,
                                      snapshots=True)[2])
        segment = 8
        kt = ops.KernelType.TORCH

    out = ops._Scan.backward(Ctx, torch.ones_like(y), torch.ones_like(h))
    assert len(out) == 9
    assert [g is not None for g in out] == list(Ctx.needs_input_grad)


def test_scan_without_a_gradient_saves_nothing():
    """Under no_grad (serving's prefill) the op returns plain tensors: no
    autograd node, no snapshots."""
    from repro_torch.kernels.mamba_scan import scan, scan_ref

    args = _scan_inputs(9, seed=6)
    with torch.no_grad():
        y, h = scan(*args)
    assert y.grad_fn is None and h.grad_fn is None
    want = scan_ref(*args)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


class _Stream:
    cuda_stream = 0


def _on_the_card(monkeypatch, ops):
    """Make the op take its kernel path with CPU tensors: kernel_mode says
    CUDA, the stream is a stub."""
    from repro_torch.kernels.interface import KernelType

    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())


def test_scan_wrappers_raise_when_the_build_fails(monkeypatch):
    """A kernel that does not build raises out of the forward and out of
    the backward; nothing runs in its place."""
    from repro_torch.kernels.mamba_scan import ops

    def no_build():
        raise RuntimeError("kernel build failed: mamba_scan")

    _on_the_card(monkeypatch, ops)
    monkeypatch.setattr(ops, "_scan_fn", no_build)
    monkeypatch.setattr(ops, "_bwd_fn", no_build)
    monkeypatch.setattr(ops, "scan_ref", lambda *a, **k: pytest.fail(
        "the plain version ran"))
    monkeypatch.setattr(ops, "scan_bwd_ref", lambda *a, **k: pytest.fail(
        "the plain backward ran"))
    args = _scan_inputs(9, seed=7)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        ops.scan(*args)
    snaps = torch.zeros(B, 1, 24, 16)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        ops.scan_bwd(*args[:5], snaps, torch.zeros(B, 9, 24))


def test_scan_wrappers_call_their_kernels_and_raise_on_failure(monkeypatch):
    """The kernel path calls its C entry points once each with the
    operands' pointers and strides (B and C as x_proj's strided views),
    counts one launch each, and raises when an entry point returns a CUDA
    error; types and sizes the kernels do not take raise before any
    launch."""
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.kernels.mamba_scan import ops

    _on_the_card(monkeypatch, ops)
    seen = {}

    def entry(name, rc):
        def fn(*args):
            seen[name] = args
            return rc
        return lambda: fn

    xc, dt, b_mat, c_mat, a, h0 = _scan_inputs(70, seed=8)
    reset_launches()
    monkeypatch.setattr(ops, "_scan_fn", entry("fwd", 0))
    monkeypatch.setattr(ops, "_bwd_fn", entry("bwd", 0))
    y, h = ops.scan(xc, dt, b_mat, c_mat, a, h0)
    args = seen["fwd"]
    assert args[0] == 0 and args[1] == xc.data_ptr()
    assert args[3] == b_mat.data_ptr() and args[4] == c_mat.data_ptr()
    assert args[5:7] == b_mat.stride()[:2] == (70 * 36, 36)
    assert args[12:15] == (B, 70, 24) and args[11] is None   # no snapshots
    assert y.shape == xc.shape and h.shape == h0.shape
    snaps = torch.zeros(B, 3, 24, 16)
    grads = ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps, torch.ones_like(xc),
                         want_dh0=True)
    args = seen["bwd"]
    assert args[10] is None and args[16] is not None      # no dh; dh0
    assert args[19:22] == (B, 70, 24)
    assert [g.shape for g in grads] == [xc.shape, dt.shape, b_mat.shape,
                                        c_mat.shape, a.shape, h0.shape]
    assert LAUNCHES["mamba_scan"] == 1 and LAUNCHES["mamba_scan_bwd"] == 1
    monkeypatch.setattr(ops, "_scan_fn", entry("fwd", 700))
    monkeypatch.setattr(ops, "_bwd_fn", entry("bwd", 700))
    with pytest.raises(RuntimeError, match="mamba_scan kernel launch failed"):
        ops.scan(xc, dt, b_mat, c_mat, a, h0)
    with pytest.raises(RuntimeError, match="mamba_scan_bwd kernel launch"):
        ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps, torch.ones_like(xc))
    with pytest.raises(TypeError, match="one type"):
        ops.scan(xc, dt.double(), b_mat, c_mat, a, h0)
    with pytest.raises(ValueError, match="N = 16"):
        ops.scan(xc, dt, b_mat[..., :8], c_mat[..., :8], a[:, :8], None)
    with pytest.raises(ValueError, match="snapshots"):
        ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps[:, :1],
                     torch.ones_like(xc))
    assert LAUNCHES["mamba_scan"] == 2 and LAUNCHES["mamba_scan_bwd"] == 2


# ---------------------------------------------------------------------------
# the kernel variants: plan, plan_bwd, the ring entry points, the cadence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d_in,want", [
    (4, 1024, 16384, "ring"), (4, 1, 16384, "ring"), (2, 17, 128, "ring"),
    (1, 1000, 256, "ring"), (2, 17, 100, "simt"), (2, 64, 64, "simt"),
    (2, 9, 24, "simt"), (3, 130, 192, "simt")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_picks_ring_by_width(b, s, d_in, want, dtype):
    """plan and plan_bwd as pure functions of the shapes (meta tensors):
    ring where d_in is a multiple of 128, simt else, in either type; the
    backward for each forward variant's own cadence, None read as it."""
    from repro_torch.kernels.mamba_scan import SNAPSHOT_EVERY, plan, \
        plan_bwd

    xc = torch.empty((b, s, d_in), dtype=dtype, device="meta")
    proj = torch.empty((b, s, 512 + 32), dtype=dtype, device="meta")
    _, b_mat, c_mat = proj.split([512, 16, 16], dim=-1)
    a = torch.empty((d_in, 16), device="meta")
    assert plan(xc, xc, b_mat, c_mat, a) == want
    assert plan_bwd(xc, xc, b_mat, c_mat, a) == want
    assert plan_bwd(xc, xc, b_mat, c_mat, a, SNAPSHOT_EVERY[want]) == want
    assert plan_bwd(xc, xc, b_mat, c_mat, a, SNAPSHOT_EVERY["simt"]) == \
        "simt"
    with pytest.raises(ValueError, match="snapshots every 64"):
        plan_bwd(xc, xc, b_mat, c_mat, a, 64)


def test_bwd_scratch_and_cadences_per_variant():
    """Each variant's scratch (partial dB, dC of its CTAs' channels) and
    the one cadence each kernel takes; a cadence the variant does not take
    raises before anything launches."""
    from repro_torch.kernels.mamba_scan import BWD_CHANNELS, \
        SNAPSHOT_EVERY, bwd_scratch, ops

    xc = torch.empty((4, 1024, 16384), device="meta")
    part, part_a = bwd_scratch(xc, "ring")
    assert part.shape == (4, 1024, 128, 32) and part_a.shape == (4, 16384,
                                                                   16)
    assert bwd_scratch(xc, "simt")[0].shape == (4, 1024, 256, 32)
    assert BWD_CHANNELS == {"ring": 128, "simt": 64}
    assert SNAPSHOT_EVERY == {"ring": 8, "simt": 32}
    assert ops._variant_and_cadence("x", xc, "ring", None) == 8
    assert ops._variant_and_cadence("x", xc, "ring", 8) == 8
    assert ops._variant_and_cadence("x", xc, "simt", None) == 32
    with pytest.raises(ValueError, match="every 32 steps, got 8"):
        ops._variant_and_cadence("x", xc, "simt", 8)
    with pytest.raises(ValueError, match="every 8 steps, got 32"):
        ops._variant_and_cadence("x", xc, "ring", 32)
    with pytest.raises(ValueError, match="every"):
        ops._variant_and_cadence("x", xc, "ring", 16)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops._variant_and_cadence("x", xc[..., :100], "ring", 8)
    with pytest.raises(ValueError, match="not one of"):
        ops._variant_and_cadence("x", xc, "wgmma", 8)


def _ring_entries(monkeypatch, ops, seen, rc=0):
    """Stub every C entry point: each records its arguments under its
    name and returns ``rc``."""
    def entry(name):
        def fn(*args):
            seen.setdefault(name, []).append(args)
            return rc
        return lambda: fn

    for attr in ("_scan_fn", "_bwd_fn", "_scan_ring_fn", "_bwd_ring_fn"):
        monkeypatch.setattr(ops, attr, entry(attr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_wrappers_call_their_kernels_and_raise_on_failure(monkeypatch,
                                                               dtype):
    """At d_in 128 the kernel path calls the ring entry points once each
    (dtype code, then the operands' pointers and strides, B and C as
    x_proj's strided views where they are 16-byte aligned, else copies),
    counts one launch and one ring variant each, and raises when an entry point returns a CUDA
    error; simt named explicitly on the same tensors calls its own entry
    points; B and C views the ring does not take are copied."""
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.kernels.mamba_scan import ops

    _on_the_card(monkeypatch, ops)
    seen = {}
    _ring_entries(monkeypatch, ops, seen)
    xc, dt, b_mat, c_mat, a, h0 = _scan_inputs(70, seed=9, dtype=dtype,
                                               d_in=128)
    reset_launches()
    ops.reset_variants()
    y, h = ops.scan(xc, dt, b_mat, c_mat, a, h0)
    (args,) = seen["_scan_ring_fn"]
    code = 0 if dtype == torch.float32 else 1
    assert args[:2] == (code, xc.data_ptr())
    if dtype == torch.float32:          # views on 16-byte boundaries
        assert args[3:5] == (b_mat.data_ptr(), c_mat.data_ptr())
        assert args[5:7] == b_mat.stride()[:2] == (70 * 36, 36)
    else:                               # bf16 rows of 72 bytes: copies
        assert args[3] != b_mat.data_ptr() and args[5:7] == (70 * 16, 16)
    assert args[12:15] == (B, 70, 128) and args[11] is None
    assert y.shape == xc.shape and y.dtype == dtype
    snaps = torch.zeros(B, 9, 128, 16)                   # ceil(70 / 8)
    grads = ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps, torch.ones_like(xc),
                         want_dh0=True)
    (args,) = seen["_bwd_ring_fn"]
    assert args[0] == code and args[8] == snaps.data_ptr()
    assert args[10] is None and args[16] is not None     # no dh; dh0
    assert args[17].__class__ is int and args[19:22] == (B, 70, 128)
    assert [g.shape for g in grads] == [xc.shape, dt.shape, b_mat.shape,
                                        c_mat.shape, a.shape, h0.shape]
    assert ops.VARIANTS == {"ring": 1, "simt": 0}
    assert ops.BWD_VARIANTS == {"ring": 1, "simt": 0}
    # simt named on the same tensors, from its own 32-step snapshots
    ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps[:, :3], torch.ones_like(xc),
                 variant="simt")
    assert len(seen["_bwd_fn"]) == 1 and "_scan_fn" not in seen
    with pytest.raises(ValueError, match="snapshots"):
        ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps[:, :3],
                     torch.ones_like(xc))
    # a misaligned view (B at element 1 of its row) is copied for ring
    _, b_odd, c_odd = torch.cat([b_mat[..., :1], b_mat, c_mat], -1).split(
        [1, 16, 16], dim=-1)
    ops.scan(xc, dt, b_odd, c_odd, a, h0)
    args = seen["_scan_ring_fn"][-1]
    assert args[3] != b_odd.data_ptr() and args[5:7] == (70 * 16, 16)
    assert LAUNCHES["mamba_scan"] == 2 and LAUNCHES["mamba_scan_bwd"] == 2
    seen.clear()
    _ring_entries(monkeypatch, ops, seen, rc=700)
    with pytest.raises(RuntimeError, match="mamba_scan kernel launch failed "
                                           r"\(ring\)"):
        ops.scan(xc, dt, b_mat, c_mat, a, h0)
    with pytest.raises(RuntimeError, match="mamba_scan_bwd kernel launch "
                                           r"failed \(ring\)"):
        ops.scan_bwd(xc, dt, b_mat, c_mat, a, snaps, torch.ones_like(xc))
    assert LAUNCHES["mamba_scan"] == 3 and LAUNCHES["mamba_scan_bwd"] == 3


@pytest.mark.parametrize("d_in,variant,every", [(128, "ring", 8),
                                                (24, "simt", 32)])
def test_scan_context_keeps_the_cadence_its_backward_reads(
        monkeypatch, d_in, variant, every):
    """Under a gradient the kernel path's forward writes snapshots at its
    variant's cadence, the autograd context keeps that cadence, and the
    backward launches the same variant's kernel on those snapshots."""
    from repro_torch.kernels.mamba_scan import ops

    _on_the_card(monkeypatch, ops)
    seen = {}
    _ring_entries(monkeypatch, ops, seen)
    fwd, bwd = (("_scan_ring_fn", "_bwd_ring_fn") if variant == "ring"
                else ("_scan_fn", "_bwd_fn"))
    args = list(_scan_inputs(70, seed=10, d_in=d_in))
    args[0] = args[0].clone().requires_grad_()
    y, h = ops.scan(*args)
    assert y.grad_fn.every == every
    (fa,) = seen[fwd]
    snaps_ptr = fa[11]
    assert snaps_ptr is not None
    (dx,) = torch.autograd.grad(y.sum(), args[0])
    (ba,) = seen[bwd]
    assert ba[8] == snaps_ptr
    assert dx.shape == args[0].shape
    assert set(seen) == {fwd, bwd}
