"""The port's LLM kernels on the CPU (their plain PyTorch versions) held
against the JAX package: ``attention`` against ``attention_ref`` and the
Pallas ``flash_attention`` run in interpret mode (blocks of 64, as
``tests/test_kernels.py`` runs it); ``route_topk`` against ``route_ref``
and the Pallas ``route`` in interpret mode; dispatch and input checks.

Tolerances: attention in float32 2e-5 (the JAX suite's); in bfloat16 one
bfloat16 rounding of the output (rtol 2**-7) against the Pallas kernel,
which keeps ``p`` in float32 as the port does, and 3e-2 against
``attention_ref``, which rounds ``p`` to bfloat16 before the PV product
(ROADMAP.md queue 3). Routing: expert ids exactly, gates and statistics
within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.moe_router.moe_router import route as jax_route  # noqa
from repro.kernels.moe_router.ref import route_ref as jax_route_ref  # noqa

# the reference's ATTN_CASES (tests/test_kernels.py), then a query block
# and a decode query in the middle of a longer cache (explicit q_offset)
ATTN_CASES = [
    # (b, sq, skv, hq, hkv, d, causal, window, q_offset)
    (1, 128, 128, 4, 4, 64, True, 0, None),
    (2, 128, 128, 4, 1, 64, True, 0, None),       # GQA
    (1, 256, 256, 2, 2, 64, True, 64, None),      # sliding window
    (1, 64, 64, 4, 2, 32, False, 0, None),        # non-causal (encoder)
    (2, 1, 96, 4, 2, 64, True, 0, None),          # decode: 1 query vs cache
    (2, 40, 160, 4, 2, 64, True, 0, 70),          # mid-cache query block
    (2, 1, 160, 4, 4, 96, True, 0, 93),           # mid-cache decode, d 96
]
TOL_F32 = 2e-5
TOL_BF16_PALLAS = 2.0 ** -7     # one bfloat16 rounding of the output
TOL_BF16_REF = 3e-2             # the JAX suite's, p rounded to bf16 there


def _qkv(case, seed):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(
    map(str, c[:6])) + ("c" if c[6] else "n") + f"w{c[7]}o{c[8]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(case, dtype):
    from repro_torch.kernels.flash_attention import attention

    b, sq, skv, hq, hkv, d, causal, window, q_offset = case
    arrs = _qkv(case, seed=sum(case[:6]))
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs)
    got = attention(tq, tk, tv, causal=causal, window=window,
                    q_offset=q_offset)
    assert got.shape == (b, sq, hq, d) and got.dtype == tq.dtype
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       q_offset=q_offset, block_q=64, block_kv=64,
                       interpret=True)
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window,
                            q_offset=q_offset)
    if dtype == "float32":
        for want in (pallas, ref):
            np.testing.assert_allclose(_np(got), _np(want), atol=TOL_F32,
                                       rtol=TOL_F32)
    else:
        np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL_BF16_PALLAS,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got), _np(ref), atol=TOL_BF16_REF,
                                   rtol=TOL_BF16_REF)


def test_attention_mixed_bf16_q_f32_cache():
    """q bfloat16 against a float32 cache (the engine's default cache type
    under a bf16 model): both upcast, the output in q's type."""
    from repro_torch.kernels.flash_attention import attention

    case = (2, 1, 96, 4, 2, 64)
    q, k, v = _qkv(case, seed=7)
    got = attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k),
                    torch.from_numpy(v), q_offset=60)
    assert got.dtype == torch.bfloat16
    want = jax_flash(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k),
                     jnp.asarray(v), q_offset=60, block_q=64, block_kv=64,
                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL_BF16_PALLAS,
                               atol=1e-5)


def test_attention_fully_masked_rows_are_zero():
    """A query that sees no key (causal, q_offset below 0) comes out 0, as
    in the Pallas kernel."""
    from repro_torch.kernels.flash_attention import attention

    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 4, 8, 2, 2, 32), 3))
    out = attention(q, k, v, causal=True, q_offset=-2)
    assert torch.equal(out[:, :2], torch.zeros_like(out[:, :2]))
    assert bool((out[:, 2:].abs().sum(-1) > 0).all())


def test_attention_decode_equals_full_rows():
    """One query at q_offset i over the whole cache equals row i of the
    causal attention over the sequence (keys past i masked)."""
    from repro_torch.kernels.flash_attention import attention

    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 24, 24, 4, 2, 64), 5))
    full = attention(q, k, v, causal=True)
    for i in (0, 11, 23):
        one = attention(q[:, i:i + 1], k, v, causal=True, q_offset=i)
        torch.testing.assert_close(one[:, 0], full[:, i], atol=TOL_F32,
                                   rtol=TOL_F32)


def test_attention_checks():
    from repro_torch.kernels.flash_attention import attention

    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 4, 8, 3, 2, 32), 1))
    with pytest.raises(ValueError, match="multiple"):
        attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 4, 8, 2, 2, 32), 1))
    with pytest.raises(TypeError):
        attention(q.half(), k, v)
    with pytest.raises(TypeError):
        attention(q, k, v.bfloat16())
    with pytest.raises(ValueError, match="cuda"):
        attention(q, k, v, mode="cuda")


ROUTE_T = [64, 37, 128]
ROUTE_E = [16, 64]
ROUTE_K = [2, 4, 6]


def _logits(t, e, seed):
    """Random router logits with tied rows: row 0 all equal, row 1 two
    experts tied at the top, row 2 the top-k boundary tied."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, e)) * 2).astype(np.float32)
    x[0] = 0.5
    x[1, 3] = x[1, e - 1] = x[1].max() + 1.0
    top = np.sort(x[2])[::-1]
    x[2, np.argsort(x[2])[0]] = top[1]            # ties the 2nd largest
    return x


@pytest.mark.parametrize("t", ROUTE_T)
@pytest.mark.parametrize("e", ROUTE_E)
@pytest.mark.parametrize("k", ROUTE_K)
def test_route_topk_matches_jax(t, e, k):
    from repro_torch.kernels.moe_router import route_topk

    x = _logits(t, e, seed=t * e + k)
    gates, idx, aux = route_topk(torch.from_numpy(x), top_k=k)
    assert gates.dtype == torch.float32 and idx.dtype == torch.int32
    assert gates.shape == idx.shape == (t, k)
    jx = jnp.asarray(x)
    g_r, i_r, _, aux_r = jax_route_ref(jx, top_k=k)
    g_p, i_p, aux_p = jax_route(jx, top_k=k, interpret=True)
    for g_w, i_w, a_w in ((g_r, i_r, aux_r), (g_p, i_p, aux_p)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i_w))
        np.testing.assert_allclose(gates.numpy(), np.asarray(g_w),
                                   atol=1e-6, rtol=0)
        for key in ("mean_prob", "frac_tokens"):
            np.testing.assert_allclose(aux[key].numpy(),
                                       np.asarray(a_w[key]), atol=1e-6,
                                       rtol=0)
    # the tied rows: lowest expert index first
    assert idx[0].tolist() == list(range(k))
    assert idx[1, :2].tolist() == [3, e - 1]


def test_route_topk_bf16_logits_and_no_renormalize():
    """bfloat16 logits give bfloat16 gates (rounded, then renormalised in
    float32, as the Pallas kernel); without renormalising the gates are
    the top-k probabilities."""
    from repro_torch.kernels.moe_router import route_topk

    x = _logits(40, 16, seed=1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    for renorm in (True, False):
        gates, idx, _ = route_topk(tx, top_k=4, renormalize=renorm)
        g_p, i_p, _ = jax_route(jx, top_k=4, renormalize=renorm,
                                interpret=True)
        assert gates.dtype == torch.bfloat16
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i_p))
        np.testing.assert_allclose(_np(gates), _np(g_p), atol=1e-6, rtol=0)


def test_load_balance_loss_matches_jax():
    from repro.kernels.moe_router.ref import load_balance_loss as jax_lbl
    from repro_torch.kernels.moe_router import load_balance_loss, route_topk

    x = _logits(64, 16, seed=2)
    _, _, aux = route_topk(torch.from_numpy(x), top_k=2)
    _, _, _, aux_r = jax_route_ref(jnp.asarray(x), top_k=2)
    np.testing.assert_allclose(float(load_balance_loss(aux, 16)),
                               float(jax_lbl(aux_r, 16)), rtol=1e-6)


def test_route_topk_checks():
    from repro_torch.kernels.moe_router import route_topk

    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="top_k"):
        route_topk(x, top_k=9)
    with pytest.raises(ValueError):
        route_topk(x[0], top_k=2)
    with pytest.raises(TypeError):
        route_topk(x.half(), top_k=2)
    with pytest.raises(ValueError, match="cuda"):
        route_topk(x, top_k=2, mode="cuda")
