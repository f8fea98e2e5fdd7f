"""The port's compress ops without error feedback -- top-k, rand-k
(unbiased and not), sign -- and the int8 quantize op (plain versions, as
the CPU runs them) against the JAX package's ops, run as its own tests
run them: ``mode="interpret"`` (the Pallas kernel bodies) and
``mode="xla"`` (its ``ref.py``); quantize with ``mode="xla"``.

Inputs come from numpy seeds. Ranks, int8 codes and scales, sign bits
and every dq must be equal, with one stated difference: the sign scale
``mean |v|`` is a float32 sum taken in another order than XLA's, so it
may differ in the last bits (relative ``SIGN_RTOL``); dq is then
compared exactly with the reference's scale handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.compress import ops as J  # noqa: E402
from repro.kernels.quantize import dequantize_int8 as j_dequantize  # noqa
from repro.kernels.quantize import quantize_int8 as j_quantize  # noqa: E402
from test_torch_compress import (LEAVES, MODES, SENDERS, SIGN_RTOL,  # noqa
                                 SIZES, TIE_CASES, _inputs, _k)

OPS = ["topk", "randk", "randk_unbiased", "sign"]


def _jax_op(op, mode, k=None):
    """The JAX op over a batch of senders (vmapped, as compress_tree maps
    it), numpy in and out; sign also returns its scale."""
    if op == "topk":
        fn = lambda v, u: J.topk_compress(v, k, mode=mode)
    elif op in ("randk", "randk_unbiased"):
        fn = lambda v, u: J.randk_compress(
            u, v, k, unbiased=op == "randk_unbiased", mode=mode)
    elif op == "sign":
        fn = lambda v, u: J.sign_compress(v, mode=mode)
    else:
        fn = lambda v, u: j_quantize(v, u, mode="xla")
    vf = jax.vmap(fn)
    return lambda v, u: [np.asarray(x) for x in vf(jnp.asarray(v),
                                                    jnp.asarray(u))]


def _port_op(op, v, u, segs, scales=None):
    from repro_torch.kernels import compress as K
    from repro_torch.kernels.quantize import quantize_int8

    v, u = (torch.from_numpy(np.ascontiguousarray(a)) for a in (v, u))
    if op == "topk":
        out = K.topk(v, segs)
    elif op in ("randk", "randk_unbiased"):
        out = K.randk(u, v, segs, unbiased=op == "randk_unbiased")
    elif op == "sign":
        out = K.sign(v, segs, scales=scales)
    else:
        out = quantize_int8(v, u, segs)
    return [x.numpy() for x in out]


def _segs(op, leaves, ks=None):
    """The table of ``leaves`` (top-k / rand-k keep ``ks``, by default
    10% of each leaf)."""
    from repro_torch.kernels import compress as K

    ks = tuple(_k(p) for p in leaves) if ks is None else ks
    return K.segments(leaves, ks if op.startswith(("topk", "randk"))
                      else None)


def _assert_leaf_matches(op, got, want, v, rescale):
    """One leaf, all senders. ``rescale(scale) -> dq`` reruns the port's
    sign with the reference's scale."""
    if op != "sign":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    (bits, s, dq), (jbits, js, jdq) = got, want
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_allclose(s, js, rtol=SIGN_RTOL)
    assert (np.abs(dq - jdq) <= SIGN_RTOL * np.abs(js)[:, None]).all()
    np.testing.assert_array_equal(rescale(js), jdq)


def _one_leaf(op, v, u, k, mode):
    """(port outputs, JAX outputs, rescale) of one leaf of all senders."""
    segs = _segs(op, (v.shape[1],), None if k is None else (k,))
    got = _port_op(op, v, u, segs)
    want = _jax_op(op, mode, k)(v, u)
    if op == "sign":
        got[1] = got[1][:, 0]
    rescale = lambda js: _port_op(
        op, v, u, segs, torch.tensor(np.asarray(js, np.float32)[:, None]))[2]
    return got, want, rescale


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax(op, p, mode):
    """One leaf of p values, a batch of senders."""
    v, _, u = _inputs(SENDERS, p, seed=p + 1)
    got, want, rescale = _one_leaf(op, v, u, _k(p), mode)
    _assert_leaf_matches(op, got, want, v, rescale)


@pytest.mark.parametrize("p", SIZES)
def test_quantize_matches_jax(p):
    """q, scales and dq equal the reference's quantize_int8 leaf by
    leaf, including noise 0.5 (round to nearest, the store's export)."""
    v, _, u = _inputs(SENDERS, p, seed=p + 2)
    for noise in (u, np.full_like(u, 0.5)):
        got, want, _ = _one_leaf("quantize", v, noise, None, "xla")
        _assert_leaf_matches("quantize", got, want, v, None)


def test_quantize_one_segment_is_the_flatten_anything_form():
    """A one-segment table over a whole row is the reference's op on an
    array of any shape (flattened, rows of 128 over the flat values);
    dequantize_int8 inverts it as the reference's does."""
    from repro_torch.kernels.quantize import dequantize_int8, quantize_int8

    rng = np.random.default_rng(13)
    v = rng.standard_normal((3, 5, 47)).astype(np.float32)
    u = rng.random(v.shape).astype(np.float32)
    jq, js, jdq = (np.asarray(x) for x in j_quantize(jnp.asarray(v),
                                                      jnp.asarray(u),
                                                      mode="xla"))
    q, s, dq = quantize_int8(torch.from_numpy(v.reshape(1, -1)),
                             torch.from_numpy(u.reshape(1, -1)))
    np.testing.assert_array_equal(q.numpy().reshape(v.shape), jq)
    np.testing.assert_array_equal(s.numpy()[0], js)
    np.testing.assert_array_equal(dq.numpy().reshape(v.shape), jdq)
    back = dequantize_int8(q, s).numpy().reshape(v.shape)
    np.testing.assert_array_equal(
        back, np.asarray(j_dequantize(jnp.asarray(jq), jnp.asarray(js))))


@pytest.mark.parametrize("op", OPS + ["quantize"])
def test_multi_leaf_row_matches_jax_per_leaf(op):
    """Several leaves back to back in a padded, row-strided buffer: each
    leaf's slice (and its wire rows) equals the JAX op on that leaf; the
    columns past the last leaf read dq 0, ranks -1 and q 0."""
    b, end, ld = 4, sum(LEAVES), sum(LEAVES) + 70
    rng = np.random.default_rng(5)
    buf = np.zeros((2, b, ld), np.float32)
    buf[0, :, :end] = rng.standard_normal((b, end))
    buf[1, :, :end] = rng.random((b, end))
    buf[:, :, end:] = 7.0
    rows = torch.from_numpy(buf)
    width = end + 30
    v, u = rows[0, :, :width], rows[1, :, :width]
    segs = _segs(op, LEAVES)
    out = [x.numpy() for x in _port_op_rows(op, v, u, segs)]
    vn, un = v.numpy(), u.numpy()
    for i, (o, p) in enumerate(zip(segs.offsets, segs.lengths)):
        sl = slice(o, o + p)
        want = _jax_op(op, "xla", _k(p))(vn[:, sl], un[:, sl])
        r = slice(segs.row0[i], segs.row0[i] + -(-p // 128))
        if op == "sign":
            got = [out[0][:, r], out[1][:, i], out[2][:, sl]]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=SIGN_RTOL)
        elif op == "quantize":
            got = [out[0][:, sl], out[1][:, r], out[2][:, sl]]
            _assert_leaf_matches(op, got, want, None, None)
        else:
            _assert_leaf_matches(op, [x[:, sl] for x in out], want, None,
                                 None)
    tail = slice(end, width)
    dq = out[0] if op.startswith(("topk", "randk")) else out[2]
    np.testing.assert_array_equal(dq[:, tail], 0.0)
    if op.startswith(("topk", "randk")):
        np.testing.assert_array_equal(out[1][:, tail], -1)
    if op == "quantize":
        np.testing.assert_array_equal(out[0][:, tail], 0)


def _port_op_rows(op, v, u, segs):
    from repro_torch.kernels import compress as K
    from repro_torch.kernels.quantize import quantize_int8

    if op == "topk":
        return K.topk(v, segs)
    if op.startswith("randk"):
        return K.randk(u, v, segs, unbiased=op == "randk_unbiased")
    if op == "sign":
        return K.sign(v, segs)
    return quantize_int8(v, u, segs)


# ----------------------------------------------- ties and degenerate leaves

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_topk_ties_match_jax(case, mode):
    """Tied magnitudes keep lax.top_k's exact set: ranks fill [0, k)."""
    v, k = TIE_CASES[case]
    v = np.asarray(v, np.float32)[None]
    got, want, _ = _one_leaf("topk", v, np.zeros_like(v), k, mode)
    _assert_leaf_matches("topk", got, want, v, None)
    r = got[1][0]
    np.testing.assert_array_equal(np.sort(r[r >= 0]), np.arange(k))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", ["randk", "randk_unbiased"])
def test_randk_tied_uniforms_match_jax(op, mode):
    """Uniforms quantized to 8 levels: colliding scores keep the same
    set as lax.top_k, and the kept values carry f32(p / k)."""
    p, k = 500, 60
    rng = np.random.default_rng(9)
    u = (np.floor(rng.random(p) * 8.0) / 8.0).astype(np.float32)[None]
    v = rng.standard_normal(p).astype(np.float32)[None]
    got, want, _ = _one_leaf(op, v, u, k, mode)
    _assert_leaf_matches(op, got, want, v, None)
    assert int((got[1] >= 0).sum()) == k
    kept = got[1][0] >= 0
    scale = np.float32(p / k) if op == "randk_unbiased" else np.float32(1)
    np.testing.assert_array_equal(got[0][0, kept], v[0, kept] * scale)


def test_topk_zero_heavy_leaf_keeps_the_signal():
    """More than p - k zeros: threshold 0, every nonzero survives."""
    p, k = 300, 50
    v = np.zeros((1, p), np.float32)
    v[0, [250, 280, 299]] = [1.5, -2.0, 0.5]
    got, want, _ = _one_leaf("topk", v, np.zeros_like(v), k, "xla")
    _assert_leaf_matches("topk", got, want, v, None)
    assert (got[0][0, [250, 280, 299]] == v[0, [250, 280, 299]]).all()
    assert int((got[1] >= 0).sum()) == k


@pytest.mark.parametrize("op", ["sign", "quantize"])
def test_exact_zeros_match_jax(op):
    """An all-zero leaf with some -0.0: int8 scale 1e-12 and codes 0;
    sign bits 1 (0 >= 0), dq 0."""
    p = 200
    v = np.zeros((1, p), np.float32)
    v[0, ::3] = -0.0
    u = np.random.default_rng(3).random((1, p)).astype(np.float32)
    got, want, rescale = _one_leaf(op, v, u, None, "xla")
    _assert_leaf_matches(op, got, want, v, rescale)
    if op == "sign":
        assert (got[0] == 255).all() and (got[2] == 0).all()
    else:
        assert (got[0] == 0).all() and (got[1] == np.float32(1e-12)).all()


def test_unbiased_scales_are_the_reference_floats():
    from repro_torch.kernels import compress as K

    leaves = (1, 10, 127, 7840, 200704)
    segs = _segs("randk", leaves)
    got = K.unbiased_scales(segs, "cpu").numpy()
    want = np.asarray([np.float32(p / k) for p, k in zip(leaves, segs.ks)])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("op", OPS)
def test_backward_matches_jax_vjp(op):
    """The autograd Functions against jax.vjp of the JAX ops: top-k
    passes kept coordinates' cotangents (rand-k's times its scale) and
    zeroes dropped ones, and the uniforms get 0; sign is
    straight-through."""
    from repro_torch.kernels import compress as K

    p = 300
    v, _, u = (x[0] for x in _inputs(1, p, seed=31))
    g_dq = np.random.default_rng(32).standard_normal(p).astype(np.float32)
    k = _k(p)
    unbiased = op == "randk_unbiased"
    if op == "topk":
        f = lambda v_, u_: J.topk_compress(v_, k, mode="xla")
    elif op.startswith("randk"):
        f = lambda v_, u_: J.randk_compress(u_, v_, k, unbiased=unbiased,
                                            mode="xla")
    else:
        f = lambda v_, u_: J.sign_compress(v_, mode="xla")
    out, vjp = jax.vjp(f, jnp.asarray(v), jnp.asarray(u))
    if op == "sign":
        cot = (np.zeros(out[0].shape, jax.dtypes.float0), np.float32(0),
               g_dq)
    else:
        cot = (g_dq, np.zeros(p, jax.dtypes.float0))
    jv, ju = (np.asarray(x) for x in vjp(cot))

    tv = torch.from_numpy(v)[None].requires_grad_(True)
    tu = torch.from_numpy(u)[None].requires_grad_(True)
    segs = _segs(op, (p,))
    if op == "topk":
        dq = K.topk(tv, segs)[0]
    elif op.startswith("randk"):
        dq = K.randk(tu, tv, segs, unbiased=unbiased)[0]
    else:
        dq = K.sign(tv, segs)[2]
    (dq * torch.from_numpy(g_dq)).sum().backward()
    np.testing.assert_array_equal(tv.grad[0].numpy(), jv)
    if op.startswith("randk"):
        np.testing.assert_array_equal(tu.grad[0].numpy(), ju)
        assert not tu.grad.any()
