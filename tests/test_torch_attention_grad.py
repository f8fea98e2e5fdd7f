"""The port's attention gradient against ``jax.grad`` of the JAX
package's ``attention_ref`` (``repro/kernels/flash_attention/ref.py``),
on the CPU.

The port differentiates ``kernels.flash_attention.attention`` through a
``torch.autograd.Function``: the forward with each row's log-sum-exp
(``attention_lse_ref`` here, the kernels on the card), the backward
``attention_bwd_ref`` here and the ``flash_attention_bwd`` kernel on the
card. Causal, non-causal and windowed masks, GQA, sq != skv and
``q_offset``; float32 within 1e-5 (rtol and atol), bfloat16 within
2e-2 (the forward's tolerance). Inputs from numpy seeds. The tensor-core
backward rounds ds to bfloat16 before its dq and dk products as well as
p before dv; ``attention_bwd_ref(variant="wgmma")`` models that, and is
held to the reference's bfloat16 gradient here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention.ref import attention_ref as j_attention  # noqa: E402,E501

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (b, sq, skv, hq, hkv, d, causal, window, q_offset)
CASES = {
    "causal": (2, 24, 24, 4, 4, 32, True, 0, None),
    "non-causal sq<skv": (2, 16, 40, 4, 4, 64, False, 0, 0),
    "window": (1, 40, 40, 4, 4, 32, True, 8, None),
    "non-causal window": (1, 30, 30, 2, 2, 32, False, 7, 0),
    "gqa 6:2": (2, 24, 24, 6, 2, 64, True, 0, None),
    "gqa 4:1 sq<skv": (1, 12, 36, 4, 1, 32, True, 0, None),
    "gqa 6:3 window sq<skv": (2, 20, 50, 6, 3, 32, True, 16, None),
    "head_dim 96 q_offset": (1, 10, 30, 2, 2, 96, True, 0, 15),
}


def _inputs(case, dtype, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                      (b, sq, hq, d))]
    jd = getattr(jnp, dtype)
    jx = [jnp.asarray(a).astype(jd) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _jax_grads(jx, causal, window, q_offset):
    q, k, v, do = jx
    out, vjp = jax.vjp(lambda q, k, v: j_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset), q, k, v)
    return out, vjp(do)


def _check(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.detach().float().numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol,
        err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_matches_jax_grad(name):
    from repro_torch.kernels.flash_attention import attention

    case = CASES[name]
    causal, window, q_offset = case[6:]
    jx, tx = _inputs(case, "float32")
    jout, jgrads = _jax_grads(jx, causal, window, q_offset)
    q, k, v = (t.clone().requires_grad_() for t in tx[:3])
    out = attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    grads = torch.autograd.grad(out, (q, k, v), tx[3])
    _check(out, jout, "float32", "out")
    for g, t, jg, what in zip(grads, (q, k, v), jgrads, ("dq", "dk", "dv")):
        assert g.shape == t.shape and g.dtype == torch.float32
        _check(g, jg, "float32", what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_ref_from_lse_matches_jax_grad(name):
    """``attention_bwd_ref`` from ``attention_lse_ref``'s (out, lse), and
    the log-sum-exp itself against ``logsumexp`` of the masked scores."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
    from repro_torch.kernels.flash_attention.ref import _mask, sm_scale

    case = CASES[name]
    b, sq, skv, hq, hkv, d = case[:6]
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jx, tx = _inputs(case, "float32", seed=1)
    _, jgrads = _jax_grads(jx, causal, window, q_offset)
    q, k, v, do = tx
    out, lse = attention_lse_ref(q, k, v, **kw)
    assert torch.equal(out, attention_ref(q, k, v, **kw))
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q * sm_scale(d),
                     k.repeat_interleave(hq // hkv, dim=2))
    qo = skv - sq if q_offset is None else q_offset
    s = torch.where(_mask(sq, skv, qo, causal, window, "cpu"), s,
                    -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-5)
    grads = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for g, t, jg, what in zip(grads, (q, k, v), jgrads, ("dq", "dk", "dv")):
        assert g.shape == t.shape and g.dtype == t.dtype
        _check(g, jg, "float32", what)


@pytest.mark.parametrize("name", ["causal", "gqa 6:2", "window"])
def test_bf16_grads_match_jax_grad(name):
    """bfloat16 q, k, v: the reference rounds p to bfloat16 before PV, and
    so does the port's dv; within the forward's 2e-2."""
    from repro_torch.kernels.flash_attention import attention

    case = CASES[name]
    causal, window, q_offset = case[6:]
    jx, tx = _inputs(case, "bfloat16", seed=2)
    jout, jgrads = _jax_grads(jx, causal, window, q_offset)
    q, k, v = (t.clone().requires_grad_() for t in tx[:3])
    out = attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    grads = torch.autograd.grad(out, (q, k, v), tx[3])
    _check(out, jout, "bfloat16", "out")
    for g, jg, what in zip(grads, jgrads, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        _check(g, jg, "bfloat16", what)


def test_no_grad_forward_is_the_plain_one_and_grad_is_opt_in():
    """Without a gradient the op runs as before (no autograd node); with
    one, the output equals it bit for bit and carries a grad_fn."""
    from repro_torch.kernels.flash_attention import attention, attention_ref

    _, (q, k, v, _) = _inputs(CASES["gqa 6:2"], "float32", seed=3)
    plain = attention(q, k, v)
    assert plain.grad_fn is None
    assert torch.equal(plain, attention_ref(q, k, v))
    qg = q.clone().requires_grad_()
    out = attention(qg, k, v)
    assert out.grad_fn is not None and torch.equal(out, plain)
    with torch.no_grad():
        assert attention(qg, k, v).grad_fn is None
    (dq,) = torch.autograd.grad(out.square().sum(), (qg,))
    assert dq.shape == q.shape and torch.isfinite(dq).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_rounding_model_matches_jax_grad_bf16(name):
    """``attention_bwd_ref(variant="wgmma")`` -- p and ds rounded to
    bfloat16 before their products, as the tensor-core backward's
    operands are -- from ``attention_lse_ref``'s bfloat16 (out, lse),
    against ``jax.vjp`` of the JAX package's ``attention_ref`` in
    bfloat16, within 2e-2. The default (``"simt"``: ds in float32) is
    the function it was, and the rounding moves dq or dk."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref)

    case = CASES[name]
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jx, tx = _inputs(case, "bfloat16", seed=4)
    _, jgrads = _jax_grads(jx, causal, window, q_offset)
    q, k, v, do = tx
    out, lse = attention_lse_ref(q, k, v, **kw)
    got = attention_bwd_ref(q, k, v, out, lse, do, variant="wgmma", **kw)
    for g, t, jg, what in zip(got, (q, k, v), jgrads, ("dq", "dk", "dv")):
        assert g.shape == t.shape and g.dtype == torch.bfloat16
        _check(g, jg, "bfloat16", what)
    simt = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(simt, attention_bwd_ref(
        q, k, v, out, lse, do, variant="simt", **kw)))
    assert torch.equal(got[2], simt[2])             # dv: p rounded in both
    assert not all(torch.equal(a, b) for a, b in zip(got[:2], simt[:2]))
