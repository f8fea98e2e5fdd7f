"""The port's WKV-6 scan (``repro_torch.kernels.rwkv6_scan``) against the
JAX package on the CPU: the plain version against the reference's
``wkv6_ref`` and its Pallas kernel in interpret mode (``wkv6(...,
chunk=16, interpret=True)``), with t not a multiple of the chunk, a given
state, bfloat16 r/k/v with a float32 decay, and a state carried across a
split; and the op's dispatch (a CPU tensor runs the plain version with no
launch, ``mode="cuda"`` needs CUDA tensors, the kernel refuses an
unsupported head size before building or launching anything).

Tolerances: 1e-4 (atol and rtol) across packages, as the reference's own
``tests/test_kernels.py`` holds its oracle and Pallas kernel: the three
sum over keys in different orders. A bfloat16 output within one bf16
rounding (2^-7 relative) of the reference's. Inputs from numpy, seeded.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.kernels.rwkv6_scan.ref import wkv6_ref as j_wkv6_ref  # noqa: E402
from repro.kernels.rwkv6_scan.rwkv6_scan import wkv6 as j_wkv6  # noqa: E402

TOL = 1e-4
BF16_REL = 2.0 ** -7


def _inputs(b, t, h, n, seed, state=False):
    """r, k, v, w (b, t, h, n), u (h, n), state (b, h, n, n) or None as
    float32 numpy; w in (0, 1) as the reference's tests draw it."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.standard_normal((b, t, h, n)) for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, h, n))))
    u = 0.1 * rng.standard_normal((h, n))
    s = rng.standard_normal((b, h, n, n)) if state else None
    f32 = lambda x: None if x is None else x.astype(np.float32)
    return tuple(map(f32, (r, k, v, w, u, s)))


def _port(*arrays, dtype=torch.float32):
    return tuple(None if a is None else torch.from_numpy(a).to(dtype)
                 for a in arrays)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


SHAPES = [(1, 16, 1, 8, False), (2, 33, 2, 16, False), (1, 130, 1, 8, False),
          (2, 12, 4, 64, True)]


@pytest.mark.parametrize("b,t,h,n,state", SHAPES,
                         ids=lambda x: str(x) if not isinstance(x, bool)
                         else ("state" if x else "zeros"))
def test_wkv_matches_jax_ref_and_pallas(b, t, h, n, state):
    from repro_torch.kernels.rwkv6_scan import wkv

    arrays = _inputs(b, t, h, n, seed=b * 1000 + t + n, state=state)
    out, s = wkv(*_port(*arrays))
    assert out.dtype == torch.float32 and out.shape == (b, t, h, n)
    assert s.dtype == torch.float32 and s.shape == (b, h, n, n)
    j_args = [None if a is None else jnp.asarray(a) for a in arrays]
    for name, (jo, js) in (
            ("wkv6_ref", j_wkv6_ref(*j_args)),
            ("pallas", j_wkv6(*j_args[:5], j_args[5], chunk=16,
                              interpret=True))):
        np.testing.assert_allclose(_np(out), _np(jo), rtol=TOL, atol=TOL,
                                   err_msg=name)
        np.testing.assert_allclose(_np(s), _np(js), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_wkv_bf16_inputs_f32_decay():
    """bf16 r/k/v and a float32 w: the output is bf16 within one bf16
    rounding of the reference's, the state float32 within 1e-4."""
    from repro_torch.kernels.rwkv6_scan import wkv

    r, k, v, w, u, s0 = _inputs(2, 40, 2, 32, seed=3, state=True)
    rb, kb, vb = _port(r, k, v, dtype=torch.bfloat16)
    out, s = wkv(rb, kb, vb, *_port(w, u, s0))
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    jb = [jnp.asarray(_np(x)).astype(jnp.bfloat16) for x in (rb, kb, vb)]
    jo, js = j_wkv6_ref(*jb, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    assert jo.dtype == jnp.bfloat16
    want = _np(jo)
    assert np.all(np.abs(_np(out) - want) <= BF16_REL * np.abs(want) + 1e-5)
    np.testing.assert_allclose(_np(s), _np(js), rtol=TOL, atol=TOL)


def test_wkv_decay_stays_float32():
    """A float32 decay near 1 is not rounded to bf16 on its way in: the
    state after 1,024 steps of w = 0.9975 (decay_w0 = -6) with k = 0 is
    w^1024 ~ 0.077 of the start, not the ~0.135 of bf16(w)^1024."""
    from repro_torch.kernels.rwkv6_scan import wkv

    t, n = 1024, 16
    w = torch.full((1, t, 1, n), float(np.exp(-np.exp(-6.0))))
    z = torch.zeros(1, t, 1, n, dtype=torch.bfloat16)
    _, s = wkv(z, z, z, w, torch.zeros(1, n), torch.ones(1, 1, n, n))
    want = float(np.exp(-np.exp(-6.0), dtype=np.float64) ** t)
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_state_carry(dtype):
    """Splitting the sequence at 17 and carrying the state equals one
    scan, in the port and against the reference's split."""
    from repro_torch.kernels.rwkv6_scan import wkv

    dt = getattr(torch, dtype)
    r, k, v, w, u, s0 = _inputs(2, 50, 2, 16, seed=5, state=True)
    rt, kt, vt = _port(r, k, v, dtype=dt)
    wt, ut, st = _port(w, u, s0)
    whole_o, whole_s = wkv(rt, kt, vt, wt, ut, st)
    o1, s1 = wkv(rt[:, :17], kt[:, :17], vt[:, :17], wt[:, :17], ut, st)
    o2, s2 = wkv(rt[:, 17:], kt[:, 17:], vt[:, 17:], wt[:, 17:], ut, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), whole_o, rtol=0,
                               atol=0)
    torch.testing.assert_close(s2, whole_s, rtol=1e-6, atol=1e-6)
    if dtype == "float32":
        jo1, js1 = j_wkv6_ref(*(jnp.asarray(x[:, :17]) for x in (r, k, v, w)),
                              jnp.asarray(u), jnp.asarray(s0))
        jo2, js2 = j_wkv6_ref(*(jnp.asarray(x[:, 17:]) for x in (r, k, v, w)),
                              jnp.asarray(u), js1)
        np.testing.assert_allclose(_np(whole_o),
                                   np.concatenate([_np(jo1), _np(jo2)], 1),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(whole_s), _np(js2), rtol=TOL, atol=TOL)


def test_wkv_out_state_in_place():
    """``out_state`` receives the final state, and may be ``state`` (the
    model's cache): the result equals a fresh scan's."""
    from repro_torch.kernels.rwkv6_scan import wkv

    r, k, v, w, u, s0 = _port(*_inputs(1, 9, 2, 16, seed=8, state=True))
    want_o, want_s = wkv(r, k, v, w, u, s0)
    cache = s0.clone()
    out, s = wkv(r, k, v, w, u, cache, out_state=cache)
    assert s is cache
    torch.testing.assert_close(out, want_o, rtol=0, atol=0)
    torch.testing.assert_close(cache, want_s, rtol=0, atol=0)


def test_wkv_cpu_runs_plain_version_without_launch():
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.rwkv6_scan import wkv, wkv6_ref

    args = _port(*_inputs(1, 5, 1, 16, seed=9))
    before = LAUNCHES.get("rwkv6_scan", 0)
    for mode in (None, "torch"):
        out, s = wkv(*args[:5], mode=mode)
        want_o, want_s = wkv6_ref(*args[:5])
        torch.testing.assert_close(out, want_o, rtol=0, atol=0)
        torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    assert LAUNCHES.get("rwkv6_scan", 0) == before


def test_wkv_mode_cuda_needs_cuda_tensors():
    from repro_torch.kernels.rwkv6_scan import wkv

    args = _port(*_inputs(1, 4, 1, 64, seed=10))
    with pytest.raises(ValueError, match="CUDA"):
        wkv(*args[:5], mode="cuda")


@pytest.mark.parametrize("n", [8, 48, 128])
def test_kernel_refuses_unsupported_head_size(monkeypatch, n):
    """The kernel path (forced here, as a CUDA tensor would take it)
    rejects a head size outside HEAD_SIZES before building or launching."""
    from repro_torch.kernels.interface import LAUNCHES, KernelType
    from repro_torch.kernels.rwkv6_scan import HEAD_SIZES, ops

    assert n not in HEAD_SIZES and HEAD_SIZES == (16, 32, 64)

    def no_build(name):
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(ops, "kernel_mode", lambda t, m=None: KernelType.CUDA)
    monkeypatch.setattr(ops, "load", no_build)
    args = _port(*_inputs(1, 3, 1, n, seed=11))
    before = LAUNCHES.get("rwkv6_scan", 0)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv(*args[:5])
    assert LAUNCHES.get("rwkv6_scan", 0) == before


def test_kernel_checks_types_before_launch(monkeypatch):
    """float16 inputs, mixed r/k types and a CPU tensor are refused by the
    kernel's launcher with no launch."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.rwkv6_scan import ops

    monkeypatch.setattr(ops, "load", lambda name: pytest.fail("built"))
    r, k, v, w, u, _ = _port(*_inputs(1, 3, 2, 16, seed=12))
    out = torch.empty_like(r)
    st = torch.empty(1, 2, 16, 16)
    before = LAUNCHES.get("rwkv6_scan", 0)
    with pytest.raises(TypeError):
        ops.launch(r.half(), k.half(), v.half(), w, u, None, out.half(), st)
    with pytest.raises(TypeError):
        ops.launch(r, k.bfloat16(), v, w, u, None, out, st)
    with pytest.raises(ValueError, match="CUDA"):
        ops.launch(r, k, v, w, u, None, out, st)
    assert LAUNCHES.get("rwkv6_scan", 0) == before


def test_wkv_rejects_mismatched_shapes():
    from repro_torch.kernels.rwkv6_scan import wkv

    r, k, v, w, u, _ = _port(*_inputs(1, 4, 2, 16, seed=13))
    with pytest.raises(ValueError, match="k"):
        wkv(r, k[:, :3], v, w, u)
    with pytest.raises(ValueError, match="u"):
        wkv(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="state"):
        wkv(r, k, v, w, u, torch.zeros(1, 2, 16, 8))
