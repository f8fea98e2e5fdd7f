"""The port's Mamba (S6) mixer and Jamba's hybrid decoder against the JAX
package on the CPU, with the reference's parameters carried across
(``repro_torch.convert``); there is no kernel in the mixer, and the MoE
layers route through the plain version here.

* ``mamba_apply`` on (2, 37, d) of the reduced jamba-1.5-large-398b (d
  256, d_in 512, d_state 16, d_conv 4) in float32, without a cache and
  from a nonzero one; a prefill continued from its own cache; a prompt
  shorter than d_conv - 1 (the cache keeps the last d_conv - 1 rows of
  the window-prefixed input); a prefill and 4 ``mamba_decode`` steps
  against the full sequence and the reference's steps. rtol 1e-5 / atol
  1e-6 for one pass, 1e-4 for the decode (ROADMAP.md queue 3).
* The scan's block length (1, 4, 16, 64 steps): the outputs differ only
  in the read-out's summation order, within the one-pass tolerance.
* bfloat16: ``A_log``, ``D`` and ``dt_bias`` stay float32 in the tree and
  the SSM state in the cache. The mixer in bf16 from a nonzero cache,
  with dt about 0.5 and D 0 so that the scan is the whole output,
  against the reference's: within 2e-2 of the largest value as the
  reference is (its bf16 silu and softplus round their inner steps,
  PyTorch's once), and within 1e-6 for the state when the reference's
  two round once too, which a prefill with dt * x in bf16, a decode step
  with it in float32 or a scan from a zero state fails.
* The stack in both of Jamba's patterns: the reduced config
  ([(mamba, dense), (attn, MoE)] x 4) and its 5-layer cut with
  attn_period 8 ([(mamba, dense), (mamba, MoE), (mamba, dense), (mamba,
  MoE), (attn, dense)], the pattern of the served cut at small width):
  ``forward``, ``prefill`` and 3 ``decode_step`` logits and every cache
  leaf at rtol 1e-5 / atol 1e-5 (the models tests' tolerances). The aux
  loss: the reference's ``stack_apply`` keeps only each block's last
  position's (ROADMAP.md queue 3), the port sums every MoE layer's.
* The full 5-layer cut's tree (24,045,707,264 parameters) against the
  reference's through ``jax.eval_shape`` and ``FakeTensorMode``, and the
  reference's ``param_count``, which counts the Mamba layers otherwise.
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
from repro.configs import param_count as j_param_count  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402

ARCH = "jamba-1.5-large-398b"
RTOL, ATOL = 1e-5, 1e-6            # one pass
DECODE_TOL = 1e-4
STACK_TOL = 1e-5                   # logits and caches of the stack
# bf16 mixer, relative to the largest value; measured gaps in comments
BF16_DT = 0.5
BF16_TOL = {"y": 2e-2, "ssm": 2e-2}   # reference as it is: 1.1e-2, 8.9e-3
ONCE_TOL = {"y": 1e-2, "ssm": 1e-6}   # its silu, softplus once: 1.5e-3, 4e-8
CUT_PARAMS = 24_045_707_264        # 5 layers at the published widths
B, S = 2, 37
PATTERNS = {"reduced": {}, "cut": dict(num_layers=5, attn_period=8)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfg(**over):
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(ARCH).replace(**over)


def _to_port(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _spec(tree):
    return sorted((k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for k, v in _leaves(tree))


@functools.lru_cache(maxsize=None)
def _jmixer(dtype="float32"):
    return JMB.mamba_init(jax.random.PRNGKey(0), j_reduced(ARCH),
                          getattr(jnp, dtype))


def _x(s=S, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (B, s, j_reduced(ARCH).d_model)) * 0.3).astype(np.float32)


def _cache_np(seed=5):
    """A nonzero cache: conv window (B, 3, d_in), state (B, d_in, N)."""
    d_in = j_reduced(ARCH).mamba_expand * j_reduced(ARCH).d_model
    rng = np.random.default_rng(seed)
    return {"conv": (rng.standard_normal((B, 3, d_in)) * 0.3)
            .astype(np.float32),
            "ssm": (rng.standard_normal((B, d_in, 16)) * 0.1)
            .astype(np.float32)}


def _torch_cache(c):
    return {k: torch.from_numpy(v.copy()) for k, v in c.items()}


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True], ids=["fresh", "cached"])
def test_mamba_apply_matches_jax(cached):
    from repro_torch.models import mamba

    jp, x = _jmixer(), _x()
    jc = _cache_np() if cached else None
    want_y, want_c = JMB.mamba_apply(
        jp, j_reduced(ARCH), jnp.asarray(x),
        cache=None if jc is None else jax.tree.map(jnp.asarray, jc))
    tc = None if jc is None else _torch_cache(jc)
    y, c = mamba.mamba_apply(_to_port(jp), _cfg(), torch.from_numpy(x),
                             cache=tc)
    assert y.shape == (B, S, _cfg().d_model) and y.dtype == torch.float32
    _close(y, want_y)
    if not cached:
        assert c is None
        return
    assert c is tc                                   # written in place
    np.testing.assert_array_equal(_np(c["conv"]), _np(want_c["conv"]))
    _close(c["ssm"], want_c["ssm"])


def test_prefill_continuation_matches_jax():
    """A prefill of 17 steps, then the other 20 from its cache: the
    reference's one pass over all 37 and its cache after them."""
    from repro_torch.models import mamba

    jp, x = _jmixer(), _x()
    want_y, want_c = JMB.mamba_apply(
        jp, j_reduced(ARCH), jnp.asarray(x),
        cache=JMB.init_mamba_cache(j_reduced(ARCH), B))
    tp, cfg = _to_port(jp), _cfg()
    c = mamba.init_mamba_cache(cfg, B)
    y1, c = mamba.mamba_apply(tp, cfg, torch.from_numpy(x[:, :17]), cache=c)
    y2, c = mamba.mamba_apply(tp, cfg, torch.from_numpy(x[:, 17:]), cache=c)
    _close(torch.cat([y1, y2], 1), want_y)
    _close(c["conv"], want_c["conv"])
    _close(c["ssm"], want_c["ssm"])


def test_short_prompt_keeps_the_window():
    """Two steps from a nonzero cache: the returned window is the cache's
    last row and the two new conv inputs, as the reference's."""
    from repro_torch.models import mamba

    jp, x, jc = _jmixer(), _x(2, seed=6), _cache_np(7)
    want_y, want_c = JMB.mamba_apply(jp, j_reduced(ARCH), jnp.asarray(x),
                                     cache=jax.tree.map(jnp.asarray, jc))
    y, c = mamba.mamba_apply(_to_port(jp), _cfg(), torch.from_numpy(x),
                             cache=_torch_cache(jc))
    _close(y, want_y)
    np.testing.assert_array_equal(_np(c["conv"][:, 0]), jc["conv"][:, 2])
    _close(c["conv"], want_c["conv"])
    _close(c["ssm"], want_c["ssm"])


@pytest.mark.parametrize("scan_sized", [False, True],
                         ids=["init", "scan_sized"])
def test_prefill_then_decode_matches_full_sequence(scan_sized):
    """A prefill of 33 steps and 4 decode steps: each step's output that
    of the full sequence (the port's) and of the reference's decode from
    the reference's prefill; the caches after the last step equal. With
    the init's parameters from a zero cache (dt about 0.01, the state
    about 1e-3), and ``scan_sized``: from the nonzero cache with dt about
    0.5 and D 0, where the state is O(0.1) and the output the scan's
    alone."""
    from repro_torch.models import mamba

    jp, x = dict(_jmixer()), _x()
    jcfg, cfg = j_reduced(ARCH), _cfg()
    if scan_sized:
        jp["dt_bias"] = jnp.full_like(jp["dt_bias"],
                                      np.log(np.expm1(BF16_DT)))
        jp["D"] = jnp.zeros_like(jp["D"])
        jc = jax.tree.map(jnp.asarray, _cache_np())
        c, c_full = _torch_cache(_cache_np()), _torch_cache(_cache_np())
    else:
        jc = JMB.init_mamba_cache(jcfg, B)
        c, c_full = mamba.init_mamba_cache(cfg, B), None
    tp = _to_port(jp)
    full, _ = mamba.mamba_apply(tp, cfg, torch.from_numpy(x), cache=c_full)
    _, jc = JMB.mamba_apply(jp, jcfg, jnp.asarray(x[:, :33]), cache=jc)
    _, c = mamba.mamba_apply(tp, cfg, torch.from_numpy(x[:, :33]), cache=c)
    for t in range(33, S):
        jy, jc = JMB.mamba_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = mamba.mamba_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]), c)
        assert y.shape == (B, 1, cfg.d_model)
        _close(y, full[:, t:t + 1], DECODE_TOL, DECODE_TOL, f"step {t}")
        _close(y, jy, DECODE_TOL, DECODE_TOL, f"step {t}")
    _close(c["conv"], jc["conv"], DECODE_TOL, DECODE_TOL)
    _close(c["ssm"], jc["ssm"], DECODE_TOL, DECODE_TOL)
    if scan_sized:
        _close(c["ssm"], c_full["ssm"], DECODE_TOL, DECODE_TOL)
        assert np.abs(_np(c["ssm"])).max() > 0.1


@pytest.mark.parametrize("block", [1, 4, 16, 64])
def test_block_length_does_not_change_the_output(block, monkeypatch):
    from repro_torch.models import mamba

    tp, cfg, x = _to_port(_jmixer()), _cfg(), torch.from_numpy(_x())
    want_c, got_c = (_torch_cache(_cache_np()) for _ in range(2))
    monkeypatch.setattr(mamba, "SCAN_BLOCK", S)
    want, _ = mamba.mamba_apply(tp, cfg, x, cache=want_c)
    monkeypatch.setattr(mamba, "SCAN_BLOCK", block)
    got, _ = mamba.mamba_apply(tp, cfg, x, cache=got_c)
    _close(got, want)
    _close(got_c["ssm"], want_c["ssm"])
    assert torch.equal(got_c["conv"], want_c["conv"])


def test_bf16_tree_keeps_float32_leaves():
    """``mamba_init`` in bf16: the reference's names, shapes and dtypes
    (A_log, D, dt_bias float32), their values the reference's exactly;
    the cache's conv window in the cache dtype, its state float32."""
    from repro_torch.models import mamba

    cfg = _cfg()
    jp = _jmixer("bfloat16")
    tp = mamba.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16)
    assert _spec(tp) == _spec(_to_port(jp))
    assert {k for k, _, d in _spec(tp) if d == "float32"} == {
        "/A_log", "/D", "/dt_bias"}
    for name in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(_np(tp[name]), _np(jp[name]), name)
    # A_log is log(1..16) rounded to float32; XLA's log(7) is one ulp off
    # the rounded value, PyTorch's is not
    a = np.log(np.arange(1, 17, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_np(tp["A_log"]), np.broadcast_to(
        a, tp["A_log"].shape))
    np.testing.assert_array_max_ulp(_np(tp["A_log"]), _np(jp["A_log"]), 1)
    c = mamba.init_mamba_cache(cfg, B, torch.bfloat16)
    jc = JMB.init_mamba_cache(j_reduced(ARCH), B, jnp.bfloat16)
    assert _spec(c) == _spec(_to_port(jc))
    assert c["ssm"].dtype == torch.float32


def _once(fn):
    """``fn`` computed in float32 and rounded once to its input's type, as
    PyTorch's bf16 ``silu`` and ``softplus`` are."""
    return lambda v: fn(v.astype(jnp.float32)).astype(v.dtype)


def _bf16_errors(variant="kept"):
    """Relative errors, max |port - reference| / max |reference|, of the
    bf16 mixer: a prefill of 33 steps from the nonzero cache (dt * x in
    float32), then 4 decode steps (dt * x in bf16, cast afterwards). dt
    is about 0.5 and D is 0, so that y is the scan's read-out C . h alone.
    Keys: "y", the worst of the prefill's and each step's output; "ssm",
    the worst of the state after the prefill and after the last step.
    ``variant`` replaces a part of the port's mixer: "prefill_dtx_bf16"
    scans with the decode's step (dt * x in bf16), "decode_dtx_f32"
    steps with dt * x in float32, "state_zeroed" scans from a zero
    state."""
    from repro_torch.models import mamba

    def scan_dtx_bf16(xc, dt, b_mat, c_mat, a, h0, block, out_dtype):
        ys, h = [], h0
        for t in range(xc.shape[1]):
            y, h = step(h, xc[:, t], dt[:, t], b_mat[:, t], c_mat[:, t], a,
                        out_dtype)
            ys.append(y)
        return torch.stack(ys, 1), h

    scan, step = mamba._scan, mamba._step
    patched = {
        "kept": {},
        "prefill_dtx_bf16": {"_scan": scan_dtx_bf16},
        "decode_dtx_f32": {"_step": lambda h, xc, dt, *r: step(
            h, xc.float(), dt.float(), *r)},
        "state_zeroed": {"_scan": lambda xc, dt, b, c, a, h0, *r: scan(
            xc, dt, b, c, a, torch.zeros_like(h0), *r)},
    }[variant]
    jcfg, cfg = j_reduced(ARCH), _cfg()
    jp = dict(_jmixer("bfloat16"))
    jp["dt_bias"] = jnp.full_like(jp["dt_bias"], np.log(np.expm1(BF16_DT)))
    jp["D"] = jnp.zeros_like(jp["D"])
    tp = _to_port(jp)
    x = jnp.asarray(_x()).astype(jnp.bfloat16)
    tx = torch.from_numpy(_x()).to(torch.bfloat16)
    jc = {k: jnp.asarray(v).astype(jnp.bfloat16 if k == "conv" else
                                   jnp.float32)
          for k, v in _cache_np().items()}
    c = {k: v.to(torch.bfloat16 if k == "conv" else torch.float32)
         for k, v in _torch_cache(_cache_np()).items()}
    err = {"y": [], "ssm": []}

    def rel(key, got, want):
        got, want = _np(got), _np(want)
        err[key].append(np.abs(got - want).max() / np.abs(want).max())

    try:
        for name, fn in patched.items():
            setattr(mamba, name, fn)
        jy, jc = JMB.mamba_apply(jp, jcfg, x[:, :33], cache=jc)
        y, c = mamba.mamba_apply(tp, cfg, tx[:, :33], cache=c)
        assert y.dtype == torch.bfloat16 and c["ssm"].dtype == torch.float32
        rel("y", y, jy)
        rel("ssm", c["ssm"], jc["ssm"])
        for t in range(33, S):
            jy, jc = JMB.mamba_decode(jp, jcfg, x[:, t:t + 1], jc)
            y, c = mamba.mamba_decode(tp, cfg, tx[:, t:t + 1], c)
            assert y.dtype == torch.bfloat16
            rel("y", y, jy)
        rel("ssm", c["ssm"], jc["ssm"])
    finally:
        mamba._scan, mamba._step = scan, step
    return {k: max(v) for k, v in err.items()}


@pytest.mark.parametrize("variant", ["kept", "state_zeroed"])
def test_bf16_mixer_matches_jax(variant):
    """bf16 params, input and cache against the reference as it is, within
    ``BF16_TOL`` of the largest value. The gap is the reference's bf16
    ``jax.nn.silu`` and ``jax.nn.softplus``, which round their inner
    steps, where PyTorch's round once (over 10^5 normal inputs the
    reference's silu is up to 2 ulps off in 40% of values, its softplus
    1 ulp in 17%); it hides the dt * x precision split (errors 1.1e-2
    and 9.9e-3 with the prefill's dt * x in bf16,
    ``test_bf16_scan_keeps_the_precision_split``), but not a scan that
    drops its state (y 0.84)."""
    err = _bf16_errors(variant)
    within = all(err[k] <= BF16_TOL[k] for k in err)
    assert within == (variant == "kept"), err


@pytest.mark.parametrize("variant", ["kept", "prefill_dtx_bf16",
                                     "decode_dtx_f32", "state_zeroed"])
def test_bf16_scan_keeps_the_precision_split(variant, monkeypatch):
    """The same run with the reference's silu and softplus rounding once,
    as PyTorch's do: the states then agree within ``ONCE_TOL`` (float32
    rounding), which a scan that multiplies dt * x in bf16, a decode step
    that multiplies it in float32, or a scan that drops its state fails."""
    monkeypatch.setattr(jax.nn, "silu", _once(jax.nn.silu))
    monkeypatch.setattr(jax.nn, "softplus", _once(jax.nn.softplus))
    err = _bf16_errors(variant)
    within = all(err[k] <= ONCE_TOL[k] for k in err)
    assert within == (variant == "kept"), err


# ---------------------------------------------------------------------------
# Jamba's hybrid stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(PATTERNS))
def jamba(request):
    """(port config, JAX config, JAX params, port params, tokens (2, 13))
    of one of Jamba's patterns at the reduced widths."""
    over = PATTERNS[request.param]
    jcfg = j_reduced(ARCH).replace(**over)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, 13)).astype(np.int32)
    return _cfg(**over), jcfg, jparams, _to_port(jparams), toks


def test_pattern_is_the_reference_pattern(jamba):
    from repro_torch.models.transformer import block_pattern

    from repro.models.transformer import block_pattern as j_block_pattern

    cfg, jcfg, *_ = jamba
    assert block_pattern(cfg) == j_block_pattern(jcfg)
    if cfg.num_layers == 5:
        assert block_pattern(cfg) == (1, [
            ("mamba", False), ("mamba", True), ("mamba", False),
            ("mamba", True), ("attn", False)])
    else:
        assert block_pattern(cfg) == (4, [("mamba", False), ("attn", True)])


def test_forward_matches_jax(jamba, monkeypatch):
    """Logits of every position; the aux loss the sum of every MoE
    layer's, where the reference keeps each block's last position's."""
    import repro_torch.models.moe as tmoe
    from repro_torch.models import model as M
    from repro_torch.models.transformer import block_pattern

    cfg, jcfg, jp, tp, toks = jamba
    want, jaux = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(toks)})
    layer_aux = []
    moe_apply = tmoe.moe_apply

    def recording(*args, **kw):
        out = moe_apply(*args, **kw)
        layer_aux.append(float(out[1]))
        return out

    monkeypatch.setattr(tmoe, "moe_apply", recording)
    got, aux = M.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, 13, cfg.vocab_size)
    _close(got, want, STACK_TOL, STACK_TOL)
    assert len(layer_aux) == sum(cfg.moe_layer_mask())
    np.testing.assert_allclose(float(aux), sum(layer_aux), rtol=1e-6)
    if block_pattern(cfg)[1][-1][1]:   # every MoE layer ends a block
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        assert float(jaux) == 0.0 < float(aux)


def test_prefill_and_decode_match_jax(jamba):
    """Prefill of 10 tokens then 3 decode steps: each step's logits and,
    after each, every cache leaf (KV slots, conv windows, SSM states)."""
    from repro_torch.models import model as M

    cfg, jcfg, jp, tp, toks = jamba
    jc = JM.init_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = M.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    assert _spec(tc) == _spec(_to_port(jc))

    def compare_cache():
        jn = jax.tree.map(np.asarray, jc)
        for pos, leaves in tc["layers"].items():
            for name, t in leaves.items():
                _close(t, jn["layers"][pos][name], STACK_TOL, STACK_TOL,
                       f"{pos}/{name}")

    jl, jc = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(toks[:, :10])}, jc)
    tl, tc = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :10])},
                       tc)
    _close(tl, jl, STACK_TOL, STACK_TOL)
    compare_cache()
    j_decode = jax.jit(lambda p, c, b, i: JM.decode_step(p, jcfg, c, b, i))
    for pos in range(10, 13):
        tok = toks[:, pos:pos + 1]
        jl, jc = j_decode(jp, jc, {"tokens": jnp.asarray(tok)},
                          jnp.int32(pos))
        tl, tc = M.decode_step(tp, cfg, tc, {"tokens": torch.from_numpy(tok)},
                               pos)
        _close(tl, jl, STACK_TOL, STACK_TOL, f"decode {pos}")
        compare_cache()


def test_cut_tree_matches_jax_without_allocating():
    """The served cut (5 layers at the published widths) in bf16: the
    reference's leaf names, shapes and dtypes, 24,045,707,264 parameters;
    the reference's param_count counts its Mamba layers otherwise (d_in /
    16 for dt_rank, no dt_proj, dt_bias, A_log or D), and the port keeps
    that function."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    jcfg = j_config(ARCH).replace(num_layers=5)
    shapes = jax.eval_shape(functools.partial(
        JM.init_params, cfg=jcfg, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    want = sorted(("/".join(str(p.key) for p in path), tuple(v.shape),
                   str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      shapes)[0])
    cfg = get_config(ARCH).replace(num_layers=5)
    with FakeTensorMode():
        mine = M.init_params(0, cfg, dtype=torch.bfloat16, device="cpu")
        got = [(k.lstrip("/"), s, d) for k, s, d in _spec(mine)]
    assert got == want
    assert sum(int(np.prod(s)) for _, s, _ in want) == CUT_PARAMS
    assert param_count(cfg) == j_param_count(jcfg) == 24_044_519_424
    f32 = {k.split("/")[-1] for k, _, d in want if d == "float32"}
    assert f32 == {"A_log", "D", "dt_bias", "router"}
