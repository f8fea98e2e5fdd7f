"""Whisper's encoder-decoder and Qwen2-VL's embeds prefill and M-RoPE
decode in the port, against the JAX package on the reduced configs (2
layers, d_model 256, encoder_seq_len 64, vocab 512), on the CPU (the
kernels' plain versions).

* Trees: the port's ``init_params`` draws the reference's leaf paths,
  shapes and types (the encoder's leaves stacked over its layers, each
  decoder layer's ``norm_x`` and ``cross``); a bfloat16 reference tree
  crosses bit for bit.
* Whisper's ``encoder_apply``, and ``forward`` logits of both models with
  the reference's parameters carried across: rtol 1e-5 / atol 1e-5 (one
  pass), the reduced decoders' tolerance (``test_torch_llm_models.py``).
  The packages sum each product in another order; over two layers of
  widths 256 and 512 that leaves up to 3.3e-6 on values of order 1, so
  the paper models' atol of 1e-6 (ROADMAP.md queue 3) does not hold here.
* ``prefill`` then three ``decode_step``\\ s: every step's logits and the
  cache after the last (Whisper's ``cross_k`` / ``cross_v`` included)
  within 1e-4 (decode steps; queue 3).
* ``ServeEngine`` greedy tokens equal to the JAX ``ServeEngine``'s.
* The port's own teacher forcing (``tests/test_decode_consistency.py``):
  prefill + decode reproduce the full forward within 2e-4, Whisper's
  with its cached cross K/V, and the VLM's decode at M-RoPE position
  ``pos`` equal to a forward whose last embedding is that token's.
* Non-causal attention with sq != skv and a ragged skv (the
  cross-attention's shape): the port's ``attention_ref`` against JAX's
  ``attention_ref`` and the Pallas kernel in interpret mode, float32
  within 2e-5 (the JAX suite's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402

ONE_PASS = dict(rtol=1e-5, atol=1e-5)      # forward, encoder, prefill
DECODE = dict(rtol=1e-4, atol=1e-4)        # decode steps and the cache
CONSISTENCY = dict(rtol=2e-4, atol=2e-4)   # tests/test_decode_consistency
ATTN_F32 = 2e-5                            # tests/test_kernels.py's
ARCHS = ["whisper-small", "qwen2-vl-2b"]
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


def _batch(cfg, toks, rng, s):
    """numpy prefill inputs for ``s`` positions: a VLM's embeds with
    distinct M-RoPE components, else tokens (and an encoder-decoder's
    frames)."""
    b = toks.shape[0]
    if cfg.family == "vlm":
        pos = np.stack([np.arange(s), np.arange(s) // 2, np.arange(s) % 3],
                       -1).astype(np.int32)
        return {"embeds": (rng.standard_normal((b, s, cfg.d_model))
                           * 0.2).astype(np.float32),
                "mrope_positions": np.broadcast_to(pos, (b, s, 3)).copy()}
    batch = {"tokens": toks[:, :s]}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)) * 0.2).astype(np.float32)
    return batch


def _decode_batch(cfg, tok, pos):
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["mrope_positions"] = np.full((tok.shape[0], 1, 3), pos,
                                           np.int32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX config, JAX params, port params, tokens (B, S +
    DECODES), prefill batch) of one reduced arch."""
    arch = request.param
    jcfg = j_reduced(arch)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jcfg.vocab_size,
                        (B, S + DECODES)).astype(np.int32)
    return (arch, jcfg, jparams, _to_port(jparams), toks,
            _batch(jcfg, toks, rng, S))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_dtypes(arch):
    """The port's init draws the reference's tree: the same leaf paths,
    shapes and types, the encoder included."""
    from repro_torch.models import model as M

    tp = M.init_params(0, _port_cfg(arch), dtype=torch.bfloat16,
                       device="cpu")
    jp = jax.eval_shape(lambda k: JM.init_params(
        k, j_reduced(arch), dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    jflat, tflat = _flat(jp), _flat(tp)
    assert jflat.keys() == tflat.keys()
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == str(v.dtype), k
    if arch == "whisper-small":
        assert "['encoder']['layers']['attn']['wq']" in tflat
        assert "['blocks']['pos0']['cross']['wk']" in tflat


def test_bf16_encdec_tree_crosses_bit_for_bit():
    """A bfloat16 Whisper tree, encoder and cross-attention included,
    becomes torch.bfloat16 leaves with the same bits."""
    jp = JM.init_params(jax.random.PRNGKey(1), j_reduced("whisper-small"),
                        dtype=jnp.bfloat16)
    tp = _flat(_to_port(jp))
    for k, leaf in _flat(jp).items():
        a = np.asarray(leaf)
        assert a.dtype.name == "bfloat16" and tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=k)


# ---------------------------------------------------------------------------
# one pass against the reference
# ---------------------------------------------------------------------------

def test_encoder_apply_matches_jax():
    from repro_torch.models import transformer as T

    jcfg = j_reduced("whisper-small")
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    # nonzero LayerNorm and MLP biases, so that every leaf is read
    enc = jax.tree.map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size)
                                                    .reshape(a.shape)),
                       jparams["encoder"])
    frames = (np.random.default_rng(3).standard_normal(
        (B, jcfg.encoder_seq_len, jcfg.d_model)) * 0.2).astype(np.float32)
    want = jax.jit(lambda p, f: JT.encoder_apply(p, jcfg, f))(
        enc, jnp.asarray(frames))
    got = T.encoder_apply(_to_port(enc), _port_cfg("whisper-small"),
                          torch.from_numpy(frames))
    assert got.shape == (B, jcfg.encoder_seq_len, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **ONE_PASS)


def test_forward_matches_jax(model):
    from repro_torch.models import model as M

    arch, jcfg, jparams, tparams, _, batch = model
    cfg = _port_cfg(arch)
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(jparams,
                                                           _jax(batch))
    got, aux = M.forward(tparams, cfg, _torch(batch))
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **ONE_PASS)


def test_prefill_and_decode_match_jax(model):
    """prefill (every position's logits), then three decode steps, each
    step's logits; the cache after the last step, leaf by leaf."""
    from repro_torch.models import model as M

    arch, jcfg, jparams, tparams, toks, batch = model
    cfg = _port_cfg(arch)
    max_len = S + DECODES + 2
    jcache = JM.init_cache(jcfg, B, max_len, dtype=jnp.float32)
    tcache = M.init_cache(cfg, B, max_len, dtype=torch.float32,
                          device="cpu")
    want, jcache = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))(
        jparams, _jax(batch), jcache)
    got, tcache = M.prefill(tparams, cfg, _torch(batch), tcache)
    np.testing.assert_allclose(_np(got), _np(want), **ONE_PASS)
    j_decode = jax.jit(lambda p, c, b, i: JM.decode_step(p, jcfg, c, b, i))
    for i in range(DECODES):
        db = _decode_batch(cfg, toks[:, S + i:S + i + 1], S + i)
        jl, jcache = j_decode(jparams, jcache, _jax(db), jnp.int32(S + i))
        tl, tcache = M.decode_step(tparams, cfg, tcache, _torch(db), S + i)
        assert tl.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(tl), _np(jl), **DECODE,
                                   err_msg=f"decode step {i}")
    jc = jax.tree.map(np.asarray, jcache)
    names = set()
    for pos, leaves in tcache["layers"].items():
        for name, t in leaves.items():
            names.add(name)
            assert tuple(t.shape) == jc["layers"][pos][name].shape
            np.testing.assert_allclose(_np(t), jc["layers"][pos][name],
                                       **DECODE, err_msg=f"{pos}/{name}")
    want_names = {"k", "v"} | ({"cross_k", "cross_v"}
                               if cfg.is_encoder_decoder else set())
    assert names == want_names


def test_engine_greedy_matches_jax(model):
    from repro_torch.serve import ServeEngine

    arch, jcfg, jparams, tparams, _, batch = model
    want = JServeEngine(cfg=jcfg, params=jparams, max_len=S + 6).generate(
        _jax(batch), max_new_tokens=6)
    eng = ServeEngine(cfg=_port_cfg(arch), params=tparams, max_len=S + 6,
                      device="cpu")
    got = eng.generate(batch, max_new_tokens=6)
    assert got.shape == (B, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# prefill + decode = forward (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------

def test_encdec_prefill_then_decode_matches_forward():
    from repro_torch.models import model as M

    cfg = _port_cfg("whisper-small")
    b, s = 2, 12
    params = M.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    frames = torch.randn(b, cfg.encoder_seq_len, cfg.d_model,
                         generator=gen) * 0.2
    full, _ = M.forward(params, cfg, {"tokens": toks, "enc_frames": frames})
    cache = M.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    pre, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1],
                                         "enc_frames": frames}, cache,
                           last_only=True)
    torch.testing.assert_close(pre[:, 0], full[:, -2], **CONSISTENCY)
    # decode reads the cross K/V the prefill cached: no frames given
    dec, _ = M.decode_step(params, cfg, cache, {"tokens": toks[:, -1:]},
                           s - 1)
    torch.testing.assert_close(dec[:, 0], full[:, -1], **CONSISTENCY)


def test_vlm_prefill_then_decode_matches_forward():
    """The VLM prefills patch embeddings and decodes a token at M-RoPE
    position (s-1, s-1, s-1): equal to a forward over the same embeddings
    whose last row is that token's embedding at that position."""
    from repro_torch.models import model as M

    cfg = _port_cfg("qwen2-vl-2b")
    b, s = 2, 10
    params = M.init_params(1, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    embeds = torch.randn(b, s, cfg.d_model, generator=gen) * 0.2
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
    embeds[:, -1] = params["embed"][tok[:, 0]]
    pos = torch.stack([torch.arange(s), torch.arange(s) // 2,
                       torch.arange(s) % 3], -1)
    pos[-1] = s - 1
    mrope = pos[None].expand(b, s, 3).to(torch.int32)
    full, _ = M.forward(params, cfg, {"embeds": embeds,
                                      "mrope_positions": mrope})
    cache = M.init_cache(cfg, b, s + 4, dtype=torch.float32, device="cpu")
    pre, cache = M.prefill(params, cfg, {"embeds": embeds[:, :-1],
                                         "mrope_positions": mrope[:, :-1]},
                           cache, last_only=True)
    assert pre.shape == (b, 1, cfg.vocab_size)
    torch.testing.assert_close(pre[:, 0], full[:, -2], **CONSISTENCY)
    dec, _ = M.decode_step(params, cfg, cache, {
        "tokens": tok, "mrope_positions": torch.full((b, 1, 3), s - 1,
                                                     dtype=torch.int32)},
        s - 1)
    assert dec.shape == (b, 1, cfg.vocab_size)
    assert bool(torch.isfinite(dec).all())
    torch.testing.assert_close(dec[:, 0], full[:, -1], **CONSISTENCY)


# ---------------------------------------------------------------------------
# non-causal attention, sq != skv (the cross-attention's shape)
# ---------------------------------------------------------------------------

# (b, sq, skv, hq, hkv, d): ragged skv, sq != skv, GQA; one decode query
CROSS_CASES = [(2, 12, 75, 4, 4, 64), (1, 12, 75, 4, 2, 64),
               (2, 1, 75, 4, 1, 32), (1, 64, 130, 2, 2, 64)]


@pytest.mark.parametrize("case", CROSS_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_noncausal_cross_attention_matches_jax(case):
    from repro_torch.kernels.flash_attention import attention, attention_ref

    b, sq, skv, hq, hkv, d = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=False, q_offset=0)
    assert got.shape == (b, sq, hq, d)
    assert torch.equal(got, attention(tq, tk, tv, causal=False, q_offset=0))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jax_attention_ref(jq, jk, jv, causal=False, q_offset=0)
    pallas = jax_flash(jq, jk, jv, causal=False, q_offset=0, block_q=64,
                       block_kv=64, interpret=True)
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_F32,
                                   atol=ATTN_F32)
