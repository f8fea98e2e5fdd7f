"""The port's LLM layers and decoder against the JAX package on reduced
configs, on the CPU (the kernels' plain versions).

* Layers: norms, RoPE / M-RoPE, sinusoidal positions, SwiGLU, GELU MLP.
* Models: ``deepseek-moe-16b`` (MoE), ``phi3-mini-3.8b`` (dense),
  ``qwen3-14b`` (GQA + qk-norm), ``yi-34b`` (GQA) and ``qwen1.5-32b``
  (q/k/v biases) with the reference's ``init_params``
  carried across (``repro_torch.convert``): ``forward`` logits,
  ``prefill`` logits and cache, three ``decode_step``\\ s. Logits within
  rtol 1e-5 / atol 1e-5 (the models test's tolerances), caches likewise.
  Router choices are recorded in both packages and compared exactly; a
  choice that differs must lie within 1e-6 of a tie in the reference,
  and only positions before the first such flip are then compared.
* The port's version of ``tests/test_decode_consistency.py``: prefill +
  decode reproduce the full forward (MoE dropless, capacity factor E, as
  there), at that file's tolerance 2e-4, Jamba's hybrid stack among them.
* Jamba's reduced tree and cache: the reference's paths, shapes and
  dtypes (its parity tests are in ``tests/test_torch_mamba.py``).

The reference's router calls are recorded through a host callback, its
``moe_apply`` traced anew inside each test's jit.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
TIE = 1e-6
ARCHS = ["deepseek-moe-16b", "phi3-mini-3.8b", "qwen3-14b", "yi-34b",
         "qwen1.5-32b"]
B, S, DECODES = 2, 10, 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_cfg(arch):
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(arch)


def _to_port(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match_jax():
    from repro_torch.models import layers as L

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        tol = 1e-6 if dtype == "float32" else 2 ** -7
        got = L.rmsnorm_apply({"scale": torch.from_numpy(scale)}, tx, 1e-6)
        want = JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx, 1e-6)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        got = L.layernorm_apply({"scale": torch.from_numpy(scale),
                                 "bias": torch.from_numpy(bias)}, tx)
        want = JL.layernorm_apply({"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)}, jx)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_and_mrope_match_jax(theta):
    from repro_torch.models import layers as L

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 40, (2, 7, 3)).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    got = L.sinusoidal_positions(30, 16)
    np.testing.assert_allclose(_np(got), _np(JL.sinusoidal_positions(30, 16)),
                               rtol=RTOL, atol=ATOL)


def test_mlps_match_jax():
    from repro_torch.models import layers as L

    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(3).standard_normal((2, 5, 32)) \
        .astype(np.float32)
    p = JL.swiglu_init(key, 32, 64)
    np.testing.assert_allclose(
        _np(L.swiglu_apply(_to_port(p), torch.from_numpy(x))),
        _np(JL.swiglu_apply(p, jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    p = jax.tree.map(lambda a: a + 0.1, JL.gelu_mlp_init(key, 32, 64))
    np.testing.assert_allclose(
        _np(L.gelu_mlp_apply(_to_port(p), torch.from_numpy(x))),
        _np(JL.gelu_mlp_apply(p, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_init_params_tree_and_dtypes():
    """The port's init draws the reference's tree: the same leaf paths and
    shapes, the router float32 in a bfloat16 model."""
    from repro_torch.models import model as M

    for arch in ARCHS:
        cfg = _port_cfg(arch)
        tp = M.init_params(0, cfg, dtype=torch.bfloat16, device="cpu")
        jp = jax.eval_shape(lambda k: JM.init_params(
            k, j_reduced(arch), dtype=jnp.bfloat16), jax.random.PRNGKey(0))
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(jp)[0]}
        tflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert jflat.keys() == tflat.keys(), arch
        for k, v in jflat.items():
            assert tuple(tflat[k].shape) == v.shape, k
            assert str(tflat[k].dtype).split(".")[-1] == str(v.dtype), k


def test_bf16_tree_crosses_bit_for_bit():
    """A bfloat16 ``init_params`` tree (ml_dtypes leaves in numpy) becomes
    torch.bfloat16 leaves with the same bits; the router stays float32."""
    jp = JM.init_params(jax.random.PRNGKey(1), j_reduced("deepseek-moe-16b"),
                        dtype=jnp.bfloat16)
    tp = _to_port(jp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
    assert tp["blocks"]["pos0"]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the decoder against the reference
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _recorded_routes(monkeypatch):
    """Record every router call of both packages: (logits, idx) lists.
    The reference's ``moe_apply`` runs unjitted inside the caller's jit,
    so that its router call is traced anew with a host callback."""
    import repro_torch.models.moe as tmoe

    rec = {"jax": [], "torch": []}
    j_orig, t_orig = jmoe.route_topk, tmoe.route_topk

    def j_route(logits, **kw):
        out = j_orig(logits, **kw)
        jax.debug.callback(
            lambda l, i: rec["jax"].append((np.asarray(l), np.asarray(i))),
            logits, out[1], ordered=True)
        return out

    def t_route(logits, **kw):
        out = t_orig(logits, **kw)
        rec["torch"].append((logits.numpy().copy(), out[1].numpy().copy()))
        return out

    monkeypatch.setattr(jmoe, "moe_apply", jmoe.moe_apply.__wrapped__)
    monkeypatch.setattr(jmoe, "route_topk", j_route)
    monkeypatch.setattr(tmoe, "route_topk", t_route)
    yield rec
    jax.effects_barrier()


def _first_flip(rec, k):
    """Token index (within the call's rows) of the first router choice
    that differs, per call; asserts each such flip lies within TIE of a
    tie in the reference's probabilities. Returns the smallest flipped
    row over all calls, or None."""
    assert len(rec["jax"]) == len(rec["torch"])
    first = None
    for (jl, ji), (_, ti) in zip(rec["jax"], rec["torch"]):
        rows = np.nonzero((np.sort(ji, 1) != np.sort(ti, 1)).any(1))[0]
        if not len(rows):
            continue
        probs = np.asarray(jax.nn.softmax(jnp.asarray(jl), axis=-1))
        top = -np.sort(-probs, axis=1)
        gap = top[rows, k - 1] - top[rows, k]
        assert (gap <= TIE).all(), f"router flip off a tie: gaps {gap}"
        first = int(rows[0]) if first is None else min(first, int(rows[0]))
    return first


@pytest.fixture(scope="module", params=ARCHS)
def llm(request):
    """(arch, JAX config, JAX params, port params, tokens (B, S + DECODES))
    for one reduced arch (vocab 512)."""
    arch = request.param
    jcfg = j_reduced(arch)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, S + DECODES)).astype(np.int32)
    return arch, jcfg, jparams, _to_port(jparams), toks


def _compare_logits(got, want, upto=None):
    g, w = _np(got), _np(want)
    if upto is not None:
        g, w = g[:, :upto], w[:, :upto]
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_forward_matches_jax(llm, monkeypatch):
    from repro_torch.models import model as M

    arch, jcfg, jparams, tparams, toks = llm
    cfg = _port_cfg(arch)
    with _recorded_routes(monkeypatch) as rec:
        want, jaux = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(
            jparams, {"tokens": jnp.asarray(toks)})
        got, aux = M.forward(tparams, cfg, {"tokens": torch.from_numpy(toks)})
        jax.effects_barrier()
    assert got.shape == (B, S + DECODES, cfg.vocab_size)
    assert got.dtype == torch.float32
    flip = _first_flip(rec, cfg.moe.top_k) if cfg.moe.num_experts else None
    assert len(rec["torch"]) == (cfg.num_layers if cfg.moe.num_experts
                                 else 0)
    if flip is None:
        np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL,
                                   atol=1e-7)
    _compare_logits(got, want, upto=None if flip is None
                    else flip % (S + DECODES))


def test_prefill_and_decode_match_jax(llm, monkeypatch):
    """prefill (all positions' logits, the cache) then three decode steps,
    each step's logits and the cache after it."""
    from repro_torch.models import model as M

    arch, jcfg, jparams, tparams, toks = llm
    cfg = _port_cfg(arch)
    max_len = S + DECODES + 2
    with _recorded_routes(monkeypatch) as rec:
        jcache = JM.init_cache(jcfg, B, max_len, dtype=jnp.float32)
        tcache = M.init_cache(cfg, B, max_len, dtype=torch.float32,
                              device="cpu")
        j_prefill = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))
        j_decode = jax.jit(lambda p, c, b, i: JM.decode_step(p, jcfg, c, b,
                                                             i))
        want, jcache = j_prefill(jparams,
                                 {"tokens": jnp.asarray(toks[:, :S])},
                                 jcache)
        got, tcache = M.prefill(tparams, cfg,
                                {"tokens": torch.from_numpy(toks[:, :S])},
                                tcache)
        steps = []
        for i in range(DECODES):
            tok = toks[:, S + i:S + i + 1]
            jl, jcache = j_decode(jparams, jcache,
                                  {"tokens": jnp.asarray(tok)},
                                  jnp.int32(S + i))
            tl, tcache = M.decode_step(tparams, cfg, tcache,
                                       {"tokens": torch.from_numpy(tok)},
                                       S + i)
            steps.append((tl, jl))
        jax.effects_barrier()
    if cfg.moe.num_experts:
        assert _first_flip(rec, cfg.moe.top_k) is None
    _compare_logits(got, want)
    # the reference's cache after its prefill, carried across, decodes
    # the first step as the reference does
    _, jc0 = j_prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                       JM.init_cache(jcfg, B, max_len, dtype=jnp.float32))
    carried, _ = M.decode_step(tparams, cfg, _to_port(jc0),
                               {"tokens": torch.from_numpy(toks[:, S:S + 1])},
                               S)
    _compare_logits(carried, steps[0][1])
    for tl, jl in steps:
        assert tl.shape == (B, 1, cfg.vocab_size)
        _compare_logits(tl, jl)
    jc = jax.tree.map(np.asarray, jcache)
    for pos, kv in tcache["layers"].items():
        for name, t in kv.items():
            np.testing.assert_allclose(
                _np(t), jc["layers"][pos][name], rtol=RTOL, atol=ATOL,
                err_msg=f"{pos}/{name}")


def test_last_only_prefill_is_the_last_row(llm):
    from repro_torch.models import model as M

    arch, _, _, tparams, toks = llm
    cfg = _port_cfg(arch)
    batch = {"tokens": torch.from_numpy(toks[:, :S])}
    full, _ = M.prefill(tparams, cfg, batch,
                        M.init_cache(cfg, B, S, device="cpu"))
    last, _ = M.prefill(tparams, cfg, batch,
                        M.init_cache(cfg, B, S, device="cpu"),
                        last_only=True)
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# prefill + decode = forward (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------

def _dropless(cfg):
    if cfg.moe.num_experts:
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


@pytest.mark.parametrize("arch", ARCHS + ["dbrx-132b",
                                          "jamba-1.5-large-398b"])
def test_prefill_then_decode_matches_forward(arch):
    from repro_torch.models import model as M

    cfg = _dropless(_port_cfg(arch))
    b, s = 2, 12
    params = M.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(0))
    full, _ = M.forward(params, cfg, {"tokens": toks})
    cache = M.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    pre, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1]}, cache,
                           last_only=True)
    torch.testing.assert_close(pre[:, 0], full[:, -2], atol=2e-4, rtol=2e-4)
    dec, _ = M.decode_step(params, cfg, cache, {"tokens": toks[:, -1:]},
                           s - 1)
    torch.testing.assert_close(dec[:, 0], full[:, -1], atol=2e-4, rtol=2e-4)


def test_multi_step_decode_matches_forward():
    from repro_torch.models import model as M

    cfg = _port_cfg("phi3-mini-3.8b")
    b, s, tail = 1, 16, 4
    params = M.init_params(2, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    full, _ = M.forward(params, cfg, {"tokens": toks})
    cache = M.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    _, cache = M.prefill(params, cfg, {"tokens": toks[:, :s - tail]}, cache,
                         last_only=True)
    for i in range(tail):
        pos = s - tail + i
        logits, cache = M.decode_step(params, cfg, cache,
                                      {"tokens": toks[:, pos:pos + 1]}, pos)
        torch.testing.assert_close(logits[:, 0], full[:, pos], atol=2e-4,
                                   rtol=2e-4)


def test_sliding_window_decode_matches_full():
    from repro_torch.models import model as M

    cfg = _port_cfg("yi-34b").replace(sliding_window=8)
    b, s = 1, 20
    params = M.init_params(3, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(3))
    full, _ = M.forward(params, cfg, {"tokens": toks})
    cache = M.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    _, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1]}, cache,
                         last_only=True)
    logits, _ = M.decode_step(params, cfg, cache, {"tokens": toks[:, -1:]},
                              s - 1)
    torch.testing.assert_close(logits[:, 0], full[:, -1], atol=2e-4,
                               rtol=2e-4)


def test_cache_full_raises():
    from repro_torch.models import model as M

    cfg = _port_cfg("phi3-mini-3.8b")
    params = M.init_params(0, cfg, device="cpu")
    cache = M.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        M.decode_step(params, cfg, cache,
                      {"tokens": torch.zeros(1, 1, dtype=torch.int32)}, 4)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_families_of_later_slices_raise(arch):
    """Jamba, the last family a slice added: the port's bf16 init tree has
    the reference's leaf paths, shapes and dtypes (the Mamba mixers'
    A_log, D and dt_bias and the router float32), and its cache the
    reference's (conv windows in the cache dtype, SSM states float32)."""
    from repro_torch.models import model as M

    def spec(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape),
                                          str(v.dtype).split(".")[-1])
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    tp = M.init_params(0, _port_cfg(arch), dtype=torch.bfloat16,
                       device="cpu")
    jp = jax.eval_shape(lambda k: JM.init_params(
        k, j_reduced(arch), dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    assert spec(tp) == spec(jp)
    f32 = {k.split("[")[-1].strip("']") for k, (_, d) in spec(tp).items()
           if d == "float32"}
    assert f32 == {"A_log", "D", "dt_bias", "router"}
    tc = M.init_cache(_port_cfg(arch), B, 8, dtype=torch.bfloat16,
                      device="cpu")
    jc = jax.eval_shape(lambda: JM.init_cache(j_reduced(arch), B, 8,
                                              dtype=jnp.bfloat16))
    assert spec(tc) == spec(jc)
    assert tc["layers"]["pos0"]["ssm"].dtype == torch.float32
