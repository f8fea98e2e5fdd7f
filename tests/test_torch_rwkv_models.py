"""The port's RWKV-6 block and the ``rwkv6-7b`` decoder against the JAX
package on the CPU (the WKV scan's plain version), with the reference's
``init_params`` carried across (``repro_torch.convert``).

* ``timemix_apply`` and ``channelmix_apply`` with and without ``last``
  and ``state``; ``forward``, ``prefill`` + ``decode_step`` and the cache,
  on the reduced config (2 layers, d 256, 4 heads of 64) in float32:
  logits within rtol 1e-5 / atol 1e-5 (the models test's tolerances), the
  WKV state (values up to ~10) within 1e-4, the token shifts exactly
  the mixes' inputs.
* The port's version of ``tests/test_decode_consistency.py``: prefill
  (s - 1) + decode reproduces forward (s), at that file's 2e-4.
* Dtype promotion: bfloat16 params with a float32 cache (the reference
  engine's default) make the mixers' outputs float32, as JAX's
  ``concatenate`` and ``@`` promote; held against the reference's mixers
  and layers at bf16 tolerance. The reference's ``lax.scan`` refuses
  the residual stream's change of type over a whole stack, so the stack
  is held against the reference's layers applied in a loop.
* The parameter tree: names, shapes and dtypes (``decay_w0`` and
  ``bonus_u`` float32 in a bf16 tree) equal to the reference's, reduced
  and at full size (7,534,546,944 parameters; the reference through
  ``jax.eval_shape``, the port under ``FakeTensorMode``, nothing
  allocated).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

ARCH = "rwkv6-7b"
RTOL, ATOL = 1e-5, 1e-5
STATE_TOL = 1e-4
BF16_TOL = 3e-2          # a few bf16 roundings (2^-8 each) of O(1) values
FULL_PARAMS = 7_534_546_944
B, S = 2, 10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfg():
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(ARCH)


def _to_port(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def _jparams(dtype="float32"):
    return JM.init_params(jax.random.PRNGKey(0), j_reduced(ARCH),
                          getattr(jnp, dtype))


def _block0(tree, mix):
    return jax.tree.map(lambda x: x[0], tree["blocks"]["pos0"][mix])


def _tokens(s=S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, j_reduced(ARCH).vocab_size, (B, s)) \
        .astype(np.int32)


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}/{k}")
    else:
        yield pre, tree


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_timemix_matches_jax(carry):
    from repro_torch.models import rwkv

    jcfg, cfg = j_reduced(ARCH), _cfg()
    jp = _block0(_jparams(), "tm")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    h, n = cfg.num_heads, cfg.rwkv_head_dim
    state = rng.standard_normal((B, h, n, n)).astype(np.float32)
    jkw = dict(last=jnp.asarray(last), state=jnp.asarray(state)) \
        if carry else {}
    tkw = dict(last=torch.from_numpy(last), state=torch.from_numpy(state)) \
        if carry else {}
    jy, (jl, js) = JR.timemix_apply(jp, jcfg, jnp.asarray(x), **jkw)
    y, (l_, s_) = rwkv.timemix_apply(_to_port(jp), cfg, torch.from_numpy(x),
                                     **tkw)
    assert y.dtype == torch.float32 and s_.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(l_), _np(jl))
    np.testing.assert_allclose(_np(s_), _np(js), rtol=RTOL, atol=STATE_TOL)


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_channelmix_matches_jax(carry):
    from repro_torch.models import rwkv

    jcfg, cfg = j_reduced(ARCH), _cfg()
    jp = _block0(_jparams(), "cm")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    jy, jl = JR.channelmix_apply(jp, jcfg, jnp.asarray(x),
                                 last=jnp.asarray(last) if carry else None)
    y, l_ = rwkv.channelmix_apply(_to_port(jp), cfg, torch.from_numpy(x),
                                  last=torch.from_numpy(last) if carry
                                  else None)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(l_), _np(jl))


def test_timemix_state_out_is_written_in_place():
    from repro_torch.models import rwkv

    cfg = _cfg()
    p = _to_port(_block0(_jparams(), "tm"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 3, cfg.d_model)).astype(np.float32))
    want_y, (_, want_s) = rwkv.timemix_apply(p, cfg, x)
    cache = torch.zeros(B, cfg.num_heads, cfg.rwkv_head_dim,
                        cfg.rwkv_head_dim)
    y, (_, s) = rwkv.timemix_apply(p, cfg, x, state=cache, state_out=cache)
    assert s is cache
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(cache, want_s, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def test_forward_matches_jax():
    from repro_torch.models import model as M

    tok = _tokens()
    want, _ = JM.forward(_jparams(), j_reduced(ARCH),
                         {"tokens": jnp.asarray(tok)})
    got, aux = M.forward(_to_port(_jparams()), _cfg(),
                         {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _compare_cache(got, want):
    for name in ("tm_last", "cm_last", "wkv"):
        g, w = got["layers"]["pos0"][name], want["layers"]["pos0"][name]
        assert g.dtype == getattr(torch, str(w.dtype)), name
        atol = STATE_TOL if name == "wkv" else ATOL
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=atol,
                                   err_msg=name)


def test_prefill_and_decode_match_jax():
    """Prefill of 7 tokens, then 3 decode steps, against the reference,
    logits and the whole recurrent cache after each step."""
    from repro_torch.models import model as M

    jcfg, cfg = j_reduced(ARCH), _cfg()
    jp, tp = _jparams(), _to_port(_jparams())
    tok = _tokens()
    jc = JM.init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    _compare_cache(tc, jc)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :7])}, jc)
    tl, tc = M.prefill(tp, cfg, {"tokens": torch.from_numpy(tok[:, :7])}, tc)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=RTOL, atol=ATOL)
    _compare_cache(tc, jc)
    for pos in range(7, 10):
        step = tok[:, pos:pos + 1]
        jl, jc = JM.decode_step(jp, jcfg, jc, {"tokens": jnp.asarray(step)},
                                pos)
        tl, tc = M.decode_step(tp, cfg, tc, {"tokens": torch.from_numpy(step)},
                               pos)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=RTOL, atol=ATOL)
        _compare_cache(tc, jc)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_then_decode_matches_forward(seed):
    """tests/test_decode_consistency.py for the port: prefill of s - 1
    tokens and one decode step reproduce the forward's logits (the last
    position and every prefill position), at that file's 2e-4."""
    from repro_torch.models import model as M

    cfg = _cfg()
    params = M.init_params(seed, cfg, device="cpu")
    tok = torch.from_numpy(_tokens(12, seed=seed + 5))
    full, _ = M.forward(params, cfg, {"tokens": tok})
    cache = M.init_cache(cfg, B, 12, dtype=torch.float32, device="cpu")
    pre, cache = M.prefill(params, cfg, {"tokens": tok[:, :-1]}, cache)
    dec, _ = M.decode_step(params, cfg, cache, {"tokens": tok[:, -1:]}, 11)
    torch.testing.assert_close(pre, full[:, :-1], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-4, atol=2e-4)


def test_prefill_continues_from_the_cache():
    """Two prefills (6 tokens, then 4) equal one of 10: the second starts
    from the token shifts and state the first left in the cache."""
    from repro_torch.models import model as M

    cfg = _cfg()
    params = _to_port(_jparams())
    tok = torch.from_numpy(_tokens())
    one, c1 = M.prefill(params, cfg, {"tokens": tok},
                        M.init_cache(cfg, B, S, torch.float32, device="cpu"))
    c2 = M.init_cache(cfg, B, S, torch.float32, device="cpu")
    _, c2 = M.prefill(params, cfg, {"tokens": tok[:, :6]}, c2)
    two, c2 = M.prefill(params, cfg, {"tokens": tok[:, 6:]}, c2)
    torch.testing.assert_close(two, one[:, 6:], rtol=RTOL, atol=ATOL)
    for name in ("tm_last", "cm_last", "wkv"):
        torch.testing.assert_close(c2["layers"]["pos0"][name],
                                   c1["layers"]["pos0"][name], rtol=RTOL,
                                   atol=STATE_TOL)


# ---------------------------------------------------------------------------
# dtype promotion: bf16 params, f32 cache
# ---------------------------------------------------------------------------

def test_mixers_promote_under_f32_cache():
    """bf16 params and input with a float32 ``last`` / state: both
    packages' mixers return float32, within bf16 tolerance; with no cache
    they stay bf16."""
    from repro_torch.models import rwkv

    jcfg, cfg = j_reduced(ARCH), _cfg()
    jtm, jcm = _block0(_jparams("bfloat16"), "tm"), \
        _block0(_jparams("bfloat16"), "cm")
    tm, cm = _to_port(jtm), _to_port(jcm)
    assert tm["decay_w0"].dtype == torch.float32 and \
        tm["bonus_u"].dtype == torch.float32 and \
        tm["w_r"].dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    h, n = cfg.num_heads, cfg.rwkv_head_dim
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jy, (jl, js) = JR.timemix_apply(jtm, jcfg, jx, last=jnp.asarray(last),
                                    state=jnp.zeros((B, h, n, n)))
    y, (l_, s_) = rwkv.timemix_apply(tm, cfg, tx,
                                     last=torch.from_numpy(last),
                                     state=torch.zeros(B, h, n, n))
    assert str(jy.dtype) == "float32" and y.dtype == torch.float32
    assert str(jl.dtype) == "bfloat16" and l_.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(jy), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(_np(s_), _np(js), rtol=BF16_TOL,
                               atol=BF16_TOL)
    jy2, _ = JR.channelmix_apply(jcm, jcfg, jx, last=jnp.asarray(last))
    y2, _ = rwkv.channelmix_apply(cm, cfg, tx, last=torch.from_numpy(last))
    assert str(jy2.dtype) == "float32" and y2.dtype == torch.float32
    np.testing.assert_allclose(_np(y2), _np(jy2), rtol=BF16_TOL,
                               atol=BF16_TOL)
    jy3, _ = JR.channelmix_apply(jcm, jcfg, jx)
    y3, _ = rwkv.channelmix_apply(cm, cfg, tx)
    assert str(jy3.dtype) == "bfloat16" and y3.dtype == torch.bfloat16


def test_stack_promotes_under_f32_cache():
    """bf16 params with a float32 cache over the whole stack: the residual
    stream turns float32 at layer 0 and stays so. The reference's scan
    refuses that change of carry type, so its layers are applied one
    block at a time; logits and every cache leaf agree at bf16
    tolerance, in the same dtypes."""
    from repro_torch.models import model as M

    jcfg, cfg = j_reduced(ARCH), _cfg()
    jp = _jparams("bfloat16")
    tok = _tokens(6)
    jc = JM.init_cache(jcfg, B, 8, dtype=jnp.float32)
    with pytest.raises(TypeError, match="carry"):
        JM.prefill(jp, jcfg, {"tokens": jnp.asarray(tok)}, jc)
    x = jp["embed"][jnp.asarray(tok)]
    n_blocks, _ = JT.block_pattern(jcfg)
    want_cache = []
    for i in range(n_blocks):
        p_i = jax.tree.map(lambda a: a[i], jp["blocks"]["pos0"])
        c_i = jax.tree.map(lambda a: a[i], jc["layers"]["pos0"])
        x, c_i, _ = JT._apply_position(p_i, jcfg, "rwkv", False, x,
                                       mode="full", cache=c_i)
        assert x.dtype == jnp.float32
        want_cache.append(c_i)
    want = JM._logits_out(jp, jcfg, x)
    tc = M.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    got, tc = M.prefill(_to_port(jp), cfg, {"tokens": torch.from_numpy(tok)},
                        tc)
    assert got.dtype == torch.float32
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL * scale)
    for i, c_i in enumerate(want_cache):
        for name, w in c_i.items():
            g = tc["layers"]["pos0"][name][i]
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------

def _spec(tree):
    return sorted((k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for k, v in _leaves(tree))


def test_reduced_tree_matches_jax():
    """The port's bf16 tree and the reference's converted one
    (``params_from_numpy`` with no ``dtype``, so its float32 leaves stay
    float32) have the same names, shapes and dtypes."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import model as M

    jp = _jparams("bfloat16")
    mine = M.init_params(0, _cfg(), dtype=torch.bfloat16, device="cpu")
    conv = params_from_numpy(jax.tree.map(np.asarray, jp))
    want = sorted((k, tuple(v.shape), str(v.dtype)) for k, v in _leaves(jp))
    assert _spec(mine) == want
    assert _spec(conv) == want
    kinds = {d for _, _, d in want}
    assert kinds == {"bfloat16", "float32"}
    assert {k for k, _, d in want if d == "float32"} == {
        "/blocks/pos0/tm/bonus_u", "/blocks/pos0/tm/decay_w0"}


def test_full_tree_matches_jax_without_allocating():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    shapes = jax.eval_shape(functools.partial(
        JM.init_params, cfg=j_config(ARCH), dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    want = sorted((k, tuple(v.shape), str(v.dtype))
                  for k, v in _leaves(shapes))
    with FakeTensorMode():
        mine = M.init_params(0, get_config(ARCH), dtype=torch.bfloat16,
                             device="cpu")
        got = _spec(mine)
    assert got == want
    assert sum(int(np.prod(s)) for _, s, _ in want) == FULL_PARAMS
