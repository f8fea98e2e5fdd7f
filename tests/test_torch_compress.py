"""The port's error-feedback compress ops (plain versions, as the CPU runs
them) against the JAX package's ops run as its own tests run them:
``mode="interpret"`` (the Pallas kernel bodies) and ``mode="xla"`` (its
``ref.py``).

Inputs come from numpy seeds. Ranks, int8 codes, int8 scales and sign
bits must be equal; dq and ef_new of top-k and rand-k and dq of int8
too. Two stated differences:

* int8 ef_new: the port computes ``msg - dq`` with dq rounded first, as
  the reference's ``ref.py`` writes it and as the CUDA kernel does
  (``__fmul_rn`` then ``__fsub_rn``). XLA on the CPU contracts
  ``msg - q * scale`` into one fused multiply-add, so the JAX ops return
  ``round(msg - q * scale)``. Both are pinned exactly here, and they
  differ by at most one rounding of ``q * scale``.
* sign dq / ef_new: the scale ``mean |msg|`` is a float32 sum taken in
  another order than XLA's, so it may differ in the last bits
  (relative 1e-6 here); the bits are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.compress import ops as J  # noqa: E402

SIZES = [1, 10, 127, 128, 129, 1000, 4097]
SENDERS = 3
MODES = ["interpret", "xla"]
SIGN_RTOL = 1e-6


def _k(p):
    return max(1, round(0.1 * p))


def _inputs(b, p, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, p)).astype(np.float32)
    e = (0.1 * rng.standard_normal((b, p))).astype(np.float32)
    u = rng.random((b, p)).astype(np.float32)
    return d, e, u


def _jax_op(op, mode, k=None):
    """The JAX op over a batch of senders (vmapped, as compress_tree_ef
    maps it), numpy in and out."""
    if op == "ef_topk":
        fn = lambda d, e, u: J.ef_topk_compress(d, e, k, mode=mode)
    elif op == "ef_randk":
        fn = lambda d, e, u: J.ef_randk_compress(u, d, e, k, mode=mode)
    elif op == "ef_int8":
        fn = lambda d, e, u: J.ef_quantize_int8(d, e, u, mode=mode)
    else:
        fn = lambda d, e, u: J.ef_sign_compress(d, e, mode=mode)
    vf = jax.vmap(fn)
    return lambda d, e, u: [np.asarray(x) for x in vf(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(u))]


def _port_op(op, d, e, u, segs):
    from repro_torch.kernels import compress as K

    d, e, u = (torch.from_numpy(np.ascontiguousarray(a)) for a in (d, e, u))
    if op == "ef_topk":
        out = K.ef_topk(d, e, segs)
    elif op == "ef_randk":
        out = K.ef_randk(u, d, e, segs)
    elif op == "ef_int8":
        out = K.ef_int8(d, e, u, segs)
    else:
        out = K.ef_sign(d, e, segs)
    return [x.numpy() for x in out]


def _fma_residual(msg, q, scales, p):
    """round(msg - q * scale) with the product exact: what XLA's fused
    multiply-add returns."""
    s = np.repeat(scales.astype(np.float64), 128, axis=-1)[..., :p]
    return (msg.astype(np.float64) - q.astype(np.float64) * s) \
        .astype(np.float32)


def _assert_leaf_matches(op, got, want, d, e):
    """One leaf, all senders: the port's outputs ``got`` against the JAX
    op's ``want`` under the rules of the module docstring."""
    if op in ("ef_topk", "ef_randk"):
        for g, w, name in zip(got, want, ("dq", "ranks", "ef_new")):
            np.testing.assert_array_equal(g, w, err_msg=name)
        return
    if op == "ef_int8":
        (q, s, dq, ef), (jq, js, jdq, jef) = got, want
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(dq, jdq)
        msg = d + e
        np.testing.assert_array_equal(ef, msg - dq)
        np.testing.assert_array_equal(jef, _fma_residual(msg, jq, js,
                                                         msg.shape[-1]))
        np.testing.assert_allclose(ef, jef, rtol=0,
                                   atol=float(np.abs(dq).max()) * 2**-23)
        return
    (bits, s, dq, ef), (jbits, js, jdq, jef) = got, want
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_allclose(s, js, rtol=SIGN_RTOL)
    scale = np.abs(js)[..., None]
    assert (np.abs(dq - jdq) <= SIGN_RTOL * scale).all()
    assert (np.abs(ef - jef)
            <= SIGN_RTOL * scale + 2**-23 * np.abs(jef)).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("op", ["ef_topk", "ef_randk", "ef_int8",
                                "ef_sign"])
def test_ef_op_matches_jax(op, p, mode):
    """One leaf of p values, a batch of senders."""
    from repro_torch.kernels import compress as K

    d, e, u = _inputs(SENDERS, p, seed=p)
    k = _k(p)
    segs = K.segments((p,), (k,) if op in ("ef_topk", "ef_randk") else None)
    got = _port_op(op, d, e, u, segs)
    want = _jax_op(op, mode, k)(d, e, u)
    if op == "ef_sign":
        got[1] = got[1][:, 0]           # (B, leaves) -> the one leaf's
    _assert_leaf_matches(op, got, want, d, e)


# leaves of one flat row: offsets 0, 10, 17, 145, 274, 1274 -- mostly not
# multiples of 4 -- and a padded row with strided senders
LEAVES = (10, 7, 128, 129, 1000, 300)


@pytest.mark.parametrize("op", ["ef_topk", "ef_randk", "ef_int8",
                                "ef_sign"])
def test_multi_leaf_row_matches_jax_per_leaf(op):
    """Several leaves back to back in a padded, row-strided buffer: each
    leaf's slice (and its wire rows) equals the JAX op on that leaf;
    the padding reads dq 0, ranks -1, q 0 and ef_new = msg."""
    from repro_torch.kernels import compress as K

    b, end, ld = 4, sum(LEAVES), sum(LEAVES) + 70
    rng = np.random.default_rng(3)
    buf = np.zeros((3, b, ld), np.float32)
    buf[:, :, :end] = rng.standard_normal((3, b, end))
    buf[1] *= 0.1
    buf[2] = np.abs(buf[2]) % 1.0
    buf[:2, :, end:] = rng.standard_normal((2, b, ld - end))
    rows = torch.from_numpy(buf)
    width = end + 30                     # (b, width) views with stride ld
    d, e, u = (rows[i, :, :width] for i in range(3))
    ks = tuple(_k(p) for p in LEAVES)
    segs = K.segments(LEAVES, ks if op in ("ef_topk", "ef_randk") else None)
    fn = {"ef_topk": lambda: K.ef_topk(d, e, segs),
          "ef_randk": lambda: K.ef_randk(u, d, e, segs),
          "ef_int8": lambda: K.ef_int8(d, e, u, segs),
          "ef_sign": lambda: K.ef_sign(d, e, segs)}[op]
    out = [x.numpy() for x in fn()]
    dn, en, un = d.numpy(), e.numpy(), u.numpy()
    for i, (o, p) in enumerate(zip(segs.offsets, segs.lengths)):
        sl = slice(o, o + p)
        want = _jax_op(op, "xla", ks[i])(dn[:, sl], en[:, sl], un[:, sl])
        r = slice(segs.row0[i], segs.row0[i] + -(-p // 128))
        if op in ("ef_topk", "ef_randk"):
            got = [x[:, sl] for x in out]
        elif op == "ef_int8":
            got = [out[0][:, sl], out[1][:, r], out[2][:, sl], out[3][:, sl]]
        else:
            got = [out[0][:, r], out[1][:, i], out[2][:, sl], out[3][:, sl]]
        _assert_leaf_matches(op, got, want, dn[:, sl], en[:, sl])
    tail = slice(end, width)
    dq, ef_new = (out[0], out[2]) if op in ("ef_topk", "ef_randk") \
        else (out[2], out[3])
    np.testing.assert_array_equal(dq[:, tail], 0.0)
    np.testing.assert_array_equal(ef_new[:, tail], dn[:, tail] + en[:, tail])
    if op in ("ef_topk", "ef_randk"):
        np.testing.assert_array_equal(out[1][:, tail], -1)
    if op == "ef_int8":
        np.testing.assert_array_equal(out[0][:, tail], 0)


# ----------------------------------------------- ties and degenerate leaves

TIE_CASES = [
    ([3.0, 5.0, 3.0, 5.0, 3.0], 3),            # ties straddle the k-cut
    ([1.0, 1.0, 1.0, 1.0, 1.0, 1.0], 2),       # all tied
    ([-2.0, 2.0, -2.0, 2.0, 0.0, 7.0], 4),     # sign-mixed ties
]


def _one(op, d, e, k, u=None, mode="xla"):
    """(port outputs, JAX outputs) of one sender's leaf."""
    from repro_torch.kernels import compress as K

    d, e = np.asarray(d, np.float32)[None], np.asarray(e, np.float32)[None]
    u = np.zeros_like(d) if u is None else np.asarray(u, np.float32)[None]
    segs = K.segments((d.shape[1],), None if k is None else (k,))
    return _port_op(op, d, e, u, segs), _jax_op(op, mode, k)(d, e, u)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_topk_ties_match_jax(case, mode):
    """Tied magnitudes keep lax.top_k's exact set: ranks fill [0, k)."""
    v, k = TIE_CASES[case]
    got, want = _one("ef_topk", v, np.zeros(len(v)), k, mode=mode)
    _assert_leaf_matches("ef_topk", got, want, None, None)
    r = got[1][0]
    np.testing.assert_array_equal(np.sort(r[r >= 0]), np.arange(k))


def test_topk_zero_heavy_leaf_keeps_the_signal():
    """More than p - k zeros: threshold 0, every nonzero survives."""
    p, k = 300, 50
    v = np.zeros(p, np.float32)
    v[[250, 280, 299]] = [1.5, -2.0, 0.5]
    got, want = _one("ef_topk", v, np.zeros(p), k)
    _assert_leaf_matches("ef_topk", got, want, None, None)
    assert (got[0][0, [250, 280, 299]] == v[[250, 280, 299]]).all()
    assert int((got[1] >= 0).sum()) == k


def test_ef_topk_sparse_delta_is_sent_whole():
    """A sparse delta with > p - k zeros goes out whole; no residual."""
    p, k = 256, 25
    d = np.zeros(p, np.float32)
    d[[200, 130]] = [3.0, -1.0]
    got, want = _one("ef_topk", d, np.zeros(p), k)
    _assert_leaf_matches("ef_topk", got, want, None, None)
    assert got[0][0, 200] == 3.0 and got[0][0, 130] == -1.0
    np.testing.assert_array_equal(got[2], 0.0)


@pytest.mark.parametrize("mode", MODES)
def test_randk_tied_uniforms_match_jax(mode):
    """Uniforms quantized to 8 levels: colliding scores keep the same
    set as lax.top_k."""
    p, k = 500, 60
    rng = np.random.default_rng(9)
    u = np.floor(rng.random(p) * 8.0) / 8.0
    d = rng.standard_normal(p)
    e = 0.1 * rng.standard_normal(p)
    got, want = _one("ef_randk", d, e, k, u=u, mode=mode)
    _assert_leaf_matches("ef_randk", got, want, None, None)
    assert int((got[1] >= 0).sum()) == k


@pytest.mark.parametrize("op", ["ef_int8", "ef_sign"])
def test_exact_zeros_match_jax(op):
    """An all-zero leaf and a leaf with -0.0: int8 scale 1e-12 and codes
    0; sign bits 1 (0 >= 0), dq 0."""
    p = 200
    d = np.zeros(p, np.float32)
    d[::3] = -0.0
    got, want = _one(op, d, np.zeros(p), None)
    if op == "ef_sign":
        got[1] = got[1][:, 0]
    _assert_leaf_matches(op, got, want, d[None], np.zeros((1, p), np.float32))
    if op == "ef_sign":
        assert (got[0] == 255).all()
        assert (got[2] == 0).all()


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("op", ["ef_topk", "ef_randk", "ef_int8",
                                "ef_sign"])
def test_backward_matches_jax_vjp(op):
    """The autograd Functions against jax.vjp of the JAX ops: top-k /
    rand-k route kept coordinates' cotangents to dq and dropped ones' to
    ef_new; int8 and sign are straight-through."""
    from repro_torch.kernels import compress as K

    p = 300
    d, e, u = (x[0] for x in _inputs(1, p, seed=11))
    rng = np.random.default_rng(12)
    g_dq = rng.standard_normal(p).astype(np.float32)
    g_ef = rng.standard_normal(p).astype(np.float32)
    k = _k(p)
    if op == "ef_topk":
        f = lambda d_, e_: J.ef_topk_compress(d_, e_, k, mode="xla")
        cot = lambda out: (g_dq, np.zeros(p, jax.dtypes.float0), g_ef)
    elif op == "ef_randk":
        f = lambda d_, e_: J.ef_randk_compress(jnp.asarray(u), d_, e_, k,
                                               mode="xla")
        cot = lambda out: (g_dq, np.zeros(p, jax.dtypes.float0), g_ef)
    elif op == "ef_int8":
        f = lambda d_, e_: J.ef_quantize_int8(d_, e_, jnp.asarray(u),
                                              mode="xla")
        cot = lambda out: (np.zeros(p, jax.dtypes.float0),
                           np.zeros(out[1].shape, np.float32), g_dq, g_ef)
    else:
        f = lambda d_, e_: J.ef_sign_compress(d_, e_, mode="xla")
        cot = lambda out: (np.zeros(out[0].shape, jax.dtypes.float0),
                           np.float32(0), g_dq, g_ef)
    out, vjp = jax.vjp(f, jnp.asarray(d), jnp.asarray(e))
    jd, je = (np.asarray(x) for x in vjp(cot(out)))

    td = torch.from_numpy(d)[None].requires_grad_(True)
    te = torch.from_numpy(e)[None].requires_grad_(True)
    tu = torch.from_numpy(u)[None]
    segs = K.segments((p,), (k,) if op in ("ef_topk", "ef_randk") else None)
    if op == "ef_topk":
        dq, _, ef_new = K.ef_topk(td, te, segs)
    elif op == "ef_randk":
        dq, _, ef_new = K.ef_randk(tu, td, te, segs)
    elif op == "ef_int8":
        _, _, dq, ef_new = K.ef_int8(td, te, tu, segs)
    else:
        _, _, dq, ef_new = K.ef_sign(td, te, segs)
    loss = (dq * torch.from_numpy(g_dq)).sum() \
        + (ef_new * torch.from_numpy(g_ef)).sum()
    loss.backward()
    np.testing.assert_array_equal(td.grad[0].numpy(), jd)
    np.testing.assert_array_equal(te.grad[0].numpy(), je)


# --------------------------------------------------- wire helpers, misc

def test_kth_threshold_matches_jax():
    from repro.kernels.compress.ref import kth_threshold as jkth
    from repro_torch.kernels.compress import kth_threshold

    rng = np.random.default_rng(5)
    score = np.abs(rng.standard_normal((3, 257))).astype(np.float32)
    score[1, :200] = 0.0
    for k in (1, 26, 100, 257):
        want = [float(jkth(jnp.asarray(row), k)) for row in score]
        got = kth_threshold(torch.from_numpy(score), k).numpy()
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_pack_unpack_topk_match_jax():
    from repro_torch.kernels import compress as K

    p, k = 300, 30
    d, e, _ = _inputs(1, p, seed=21)
    segs = K.segments((p,), (k,))
    dq, ranks, _ = K.ef_topk(torch.from_numpy(d), torch.from_numpy(e), segs)
    vals, idx = K.pack_topk(dq[0], ranks[0], k)
    jvals, jidx = J.pack_topk(jnp.asarray(dq[0].numpy()),
                              jnp.asarray(ranks[0].numpy()), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    back = K.unpack_topk(vals, idx, p)
    np.testing.assert_array_equal(back.numpy(), dq[0].numpy())
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(J.unpack_topk(jvals, jidx, p)))


def test_sign_unpack_matches_jax():
    from repro_torch.kernels import compress as K

    p = 300
    d, e, _ = _inputs(1, p, seed=22)
    d[0, :7] = 0.0
    e[0, :7] = 0.0
    bits, scales, _, _ = K.ef_sign(torch.from_numpy(d), torch.from_numpy(e),
                                   K.segments((p,)))
    got = K.sign_unpack(bits[0], scales[0, 0], p)
    want = J.sign_unpack(jnp.asarray(bits[0].numpy()),
                         jnp.float32(scales[0, 0].item()), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segments_table():
    from repro_torch.kernels import compress as K

    segs = K.segments((10, 7840), (1, 784))
    assert segs.offsets == (0, 10) and segs.row0 == (0, 1)
    assert segs.end == 7850 and segs.rows == 1 + 62
    assert K.segments((10, 7840), (1, 784)) is segs          # cached
    np.testing.assert_array_equal(
        segs.table("cpu").numpy(), [[0, 10, 1, 0], [10, 7840, 784, 1]])
    with pytest.raises(ValueError, match="at least one value"):
        K.segments((3, 0))
    with pytest.raises(ValueError, match="bad k"):
        K.segments((3, 4), (4, 1))


def test_ops_check_their_operands():
    """Wrong dtype, too few columns, mismatched senders raise; a CUDA
    kernel cannot be asked for on CPU tensors."""
    from repro_torch.kernels import compress as K

    segs = K.segments((5, 6), (1, 1))
    d = torch.zeros(2, 11)
    with pytest.raises(TypeError, match="float32"):
        K.ef_topk(d.double(), d.double(), segs)
    with pytest.raises(ValueError, match="columns"):
        K.ef_sign(d[:, :10], d[:, :10], segs)
    with pytest.raises(ValueError, match="senders"):
        K.ef_int8(d, d, torch.zeros(3, 11), segs)
    with pytest.raises(ValueError, match="thresh"):
        K.ef_topk(d, d, segs, thresh=torch.zeros(2, 3))
    with pytest.raises(ValueError, match="mode='cuda'"):
        K.ef_topk(d, d, segs, mode="cuda")
