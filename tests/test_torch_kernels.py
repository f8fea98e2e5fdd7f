"""The port's prox_update op on the CPU (its plain PyTorch version) held
against the JAX package's prox_sgd, run in Pallas interpret mode, and
against the JAX reference oracle; the stacked in-place op against a
per-leaf loop; dispatch by tensor device; the wrapper's input checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

PROX_SHAPES = [(128,), (1024,), (257,), (8, 128), (3, 5, 64), (4096,)]
BRANCHES = [(0.0, 0.0), (0.9, 0.0), (0.9, 0.01)]
TOL = {"float32": 1e-6, "bfloat16": 2e-2}     # the JAX suite's own


def _inputs(shape, dtype, seed=0):
    """theta, grad, anchor in `dtype` and an f32 momentum buffer, from
    numpy, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs[:3]]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs[:3]]
    return jx + [jnp.asarray(arrs[3])], tx + [torch.from_numpy(arrs[3])]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("shape", PROX_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,wd", BRANCHES)
def test_prox_sgd_matches_jax_interpret(monkeypatch, shape, dtype,
                                        momentum, wd):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")
    from repro.kernels.prox_update.ops import prox_sgd as jax_prox
    from repro.kernels.prox_update.ref import prox_sgd_ref as jax_ref
    from repro_torch.kernels.prox_update import prox_sgd

    (jt, jg, ja, jm), (tt, tg, ta, tm) = _inputs(shape, dtype,
                                                 seed=len(shape))
    kw = dict(alpha=0.05, lam=0.7, momentum=momentum, weight_decay=wd)
    t_p, m_p = prox_sgd(tt, tg, ta, tm, **kw)
    assert t_p.dtype == tt.dtype and m_p.dtype == torch.float32
    t_j, m_j = jax_prox(jt, jg, ja, jm, **kw)
    t_r, m_r = jax_ref(jt, jg, ja, mom_buf=jm, **kw)
    tol = TOL[dtype]
    for t_ref, m_ref in ((t_j, m_j), (t_r, m_r)):
        np.testing.assert_allclose(_np(t_p), _np(t_ref), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(m_p), _np(m_ref), atol=tol, rtol=tol)


def test_prox_sgd_formula():
    """theta' = theta - alpha*g - alpha*lam*(theta - w), momentum=0; the
    momentum buffer comes back as given."""
    from repro_torch.kernels.prox_update import prox_sgd

    _, (theta, grad, anchor, mom) = _inputs((513,), "float32", seed=3)
    t_new, m_new = prox_sgd(theta, grad, anchor, mom, alpha=0.03, lam=1.5)
    expect = theta - 0.03 * grad - 0.03 * 1.5 * (theta - anchor)
    torch.testing.assert_close(t_new, expect, atol=1e-6, rtol=1e-6)
    assert m_new is mom


@pytest.mark.parametrize("momentum,wd", BRANCHES)
def test_prox_step_flat_buffer_matches_per_leaf_loop(momentum, wd):
    """The round's op -- the stacked device tier as one padded (M*N, S)
    buffer, the anchor given as the team tier w (M, S) -- equals the
    reference's leaf-by-leaf update with the anchor broadcast over N."""
    from repro.kernels.prox_update.ops import prox_sgd_tree
    from repro_torch.flat import Layout
    from repro_torch.kernels.prox_update import prox_step_

    m, n = 3, 4
    rng = np.random.default_rng(11)
    shapes = {"a": {"b": (5,), "w": (7, 5)}, "c": (3, 3, 2, 4)}

    def tree(lead):
        return {"a": {k: rng.standard_normal(lead + s).astype(np.float32)
                      for k, s in shapes["a"].items()},
                "c": rng.standard_normal(lead + shapes["c"])
                .astype(np.float32)}

    theta, grad, mom = tree((m, n)), tree((m, n)), tree((m, n))
    w = tree((m,))
    kw = dict(alpha=0.05, lam=0.7, momentum=momentum, weight_decay=wd)
    anchor = jax.tree.map(
        lambda l: jnp.broadcast_to(l[:, None], (m, n) + l.shape[1:]), w)
    j_t, j_m = prox_sgd_tree(theta, grad, anchor, mom, mode="xla", **kw)

    layout = Layout.of(jax.tree.map(lambda l: l[0, 0], theta))
    assert layout.stride > layout.size          # padded rows

    def flat(tr, lead):
        """(lead..., leaf) numpy tree -> one (rows, stride) buffer."""
        tr = jax.tree.map(lambda l: torch.from_numpy(
            l.reshape((-1,) + l.shape[len(lead):])), tr)
        return layout.flatten(tr, lead=(int(np.prod(lead)),))

    t_buf, g_buf, m_buf = (flat(tr, (m, n)) for tr in (theta, grad, mom))
    w_buf = flat(w, (m,))
    cols = layout.columns
    prox_step_(cols(t_buf), cols(g_buf), cols(w_buf), cols(m_buf), **kw)
    assert torch.count_nonzero(t_buf[:, layout.size:]) == 0
    got_t = layout.unflatten(t_buf.reshape(m, n, -1))
    got_m = layout.unflatten(m_buf.reshape(m, n, -1))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6), got_t, j_t)
    if momentum > 0.0:
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6), got_m, j_m)


def test_kernel_mode_follows_tensor_device():
    from repro_torch.kernels.interface import KernelType, kernel_mode

    t = torch.zeros(3)
    assert kernel_mode(t) is KernelType.TORCH
    assert kernel_mode(t, "torch") is KernelType.TORCH
    assert kernel_mode(t, KernelType.TORCH) is KernelType.TORCH
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel_mode(t, "cuda")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        kernel_mode(t, "pallas")
    with pytest.raises(ValueError, match="no kernel"):
        kernel_mode(torch.zeros(3, device="meta"))


def test_cpu_path_counts_no_launch():
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.prox_update import prox_sgd, prox_step_

    before = dict(LAUNCHES)
    t = torch.ones(4, 8)
    prox_sgd(t, t, t, alpha=0.1, lam=0.1)
    prox_step_(t, t, t[:2], alpha=0.1, lam=0.1)
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "grad_shape", "anchor_rows",
                                 "no_mom", "mom_dtype", "col_stride", "dim"])
def test_prox_step_rejects_what_the_kernel_does_not_take(bad):
    from repro_torch.kernels.prox_update import prox_step_

    t, g, a = torch.zeros(6, 8), torch.zeros(6, 8), torch.zeros(3, 8)
    mom, kw = None, dict(alpha=0.1, lam=0.1)
    if bad == "dtype":
        t = t.double()
    elif bad == "grad_shape":
        g = torch.zeros(6, 7)
    elif bad == "anchor_rows":
        a = torch.zeros(4, 8)
    elif bad == "no_mom":
        kw["momentum"] = 0.9
    elif bad == "mom_dtype":
        mom, kw["momentum"] = torch.zeros(6, 8).half(), 0.9
    elif bad == "col_stride":
        t, g = torch.zeros(8, 6).t(), torch.zeros(8, 6).t()
    elif bad == "dim":
        t, g = torch.zeros(6, 8, 1), torch.zeros(6, 8, 1)
    with pytest.raises((TypeError, ValueError)):
        prox_step_(t, g, a, mom, **kw)
