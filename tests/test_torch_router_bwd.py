"""The router's whole backward (dl, dx, dw) on the CPU: its plain version
against the JAX package, the fused kernel's arithmetic, which variant
``plan_bwd`` picks, and the autograd Function and the wrapper.

The reference has no custom VJP: it differentiates ``f32(xp) @ w`` and its
XLA ``route_ref`` (``repro/models/moe.py:73-74``,
``repro/kernels/moe_router/ref.py``) with ``jax.grad``. Held against
``jax.vjp`` of that, with cotangents drawn from numpy:

  * ``route_tokens_full_bwd_ref`` (dl, dx = dl w^T in x's type, dw =
    f32(x)^T dl), for bf16 and f32 x, renormalised and not, with a padded
    last group (zero rows whose gates' cotangent is 0) and with zero rows
    and tied experts;
  * ``full_bwd_pieces``, the fused kernel's arithmetic (dl in three bf16
    pieces, w in three, dx's six products, dw's three a stage added to a
    float32 running sum), against the exact (float64) products within the
    bound the kernel's header states, and rounded to bf16 against the
    plain version within the tolerance ``chip_smoke.py`` holds the kernel
    to;
  * ``plan_bwd``'s variants and grids at the trained shapes (meta
    tensors), and what it refuses;
  * ``route_tokens``' autograd Function on the CPU against autograd of
    ``route_tokens_ref``, asking for dx, dw or both;
  * ``tokens_bwd`` with the kernel path forced and the libraries' entry
    points stubbed: the variant plan_bwd picks is launched with its C
    signature's arguments, counted once, and a failed launch or build
    raises; nothing falls back.

Tolerances: dw within 1e-5 of its largest value; f32 dx likewise; bf16 dx
within one bf16 rounding (2^-7) of each value plus 1e-5 of the largest
(the packages sum in other orders, and the rounding to bf16 may then fall
on the other side); dl as the router's gradients elsewhere (rtol 1e-5,
atol 1e-6 at unit cotangents).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.moe_router.ref import route_ref as j_route_ref  # noqa: E402

BF16_REL = 2.0 ** -7
SCALE_TOL = 1e-5            # chip_smoke.py::ROUTER_BWD_TOL_SCALE


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within(got, want, rel, msg=""):
    """got within ``rel`` of each value plus SCALE_TOL of want's largest."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, msg
    err = np.abs(g - w)
    tol = rel * np.abs(w) + SCALE_TOL * float(np.abs(w).max(initial=0.0))
    assert (err <= tol).all(), (msg, float(err.max()),
                                float((err / np.maximum(tol, 1e-30)).max()))


def _inputs(t, d, e, k, seed, pad=0, tied=False):
    """numpy x (t, d), w (d, e) at the model's scale, dG (t, k), dM (e,):
    the last ``pad`` rows of x zero and their dG 0 (a padded group); with
    ``tied`` every 5th row of x zero and experts e-1, e-2 copies of 0, 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    dG = rng.standard_normal((t, k)).astype(np.float32)
    dM = rng.standard_normal(e).astype(np.float32)
    if pad:
        x[t - pad:] = 0.0
        dG[t - pad:] = 0.0
    if tied:
        x[::5] = 0.0
        w[:, e - 1] = w[:, 0]
        w[:, e - 2] = w[:, 1]
    return x, w, dG, dM


def _j_vjp(x, w, dG, dM, k, renorm):
    """jax.vjp of the reference's f32(x) @ w -> route_ref (gates,
    mean_prob) at x (in its type) and w: (dx, dw, dl)."""
    def f(xx, ww):
        logits = xx.astype(jnp.float32) @ ww
        g, _, _, aux = j_route_ref(logits, top_k=k, renormalize=renorm)
        return g, aux["mean_prob"], logits

    (_, _, logits), vjp = jax.vjp(f, x, w)
    dx, dw = vjp((jnp.asarray(dG), jnp.asarray(dM), jnp.zeros_like(logits)))

    def g_of_logits(lg):
        g, _, _, aux = j_route_ref(lg, top_k=k, renormalize=renorm)
        return g, aux["mean_prob"]

    _, vjp_l = jax.vjp(g_of_logits, logits)
    return dx, dw, vjp_l((jnp.asarray(dG), jnp.asarray(dM)))[0]


FULL_CASES = [("plain", 0, False), ("padded last group", 17, False),
              ("zero rows, tied experts", 0, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("case", FULL_CASES, ids=[c[0] for c in FULL_CASES])
def test_full_bwd_ref_matches_jax_vjp(dtype, renorm, case):
    from repro_torch.kernels.moe_router import route_ref, \
        route_tokens_full_bwd_ref

    _, pad, tied = case
    t, d, e, k = 96, 48, 64, 6
    xn, wn, dG, dM = _inputs(t, d, e, k, seed=3 + pad, pad=pad, tied=tied)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(xn).astype(jdt)
    x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    w = torch.from_numpy(wn)
    logits = x.float() @ w
    gates, idx, _, _ = route_ref(logits, top_k=k, renormalize=renorm)
    jidx = np.asarray(j_route_ref(jx.astype(jnp.float32) @ jnp.asarray(wn),
                                  top_k=k, renormalize=renorm)[1])
    np.testing.assert_array_equal(idx.numpy(), jidx)
    dl, dx, dw = route_tokens_full_bwd_ref(
        x, w, None, idx, gates, torch.from_numpy(dG), torch.from_numpy(dM),
        renormalize=renorm)
    jdx, jdw, jdl = _j_vjp(jx, jnp.asarray(wn), dG, dM, k, renorm)
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    assert dx.shape == (t, d) and dw.shape == (d, e) and dl.shape == (t, e)
    np.testing.assert_allclose(_np(dl), _np(jdl), rtol=1e-5, atol=1e-6)
    _within(dx, jdx, BF16_REL if dtype == "bfloat16" else 0.0, "dx")
    _within(dw, jdw, 0.0, "dw")
    # the forward's own logits given, as the kernel path saves them
    again = route_tokens_full_bwd_ref(
        x, w, logits, idx, gates, torch.from_numpy(dG), torch.from_numpy(dM),
        renormalize=renorm)
    for a, b in zip(again, (dl, dx, dw)):
        assert torch.equal(a, b)


# (t, d, E, k, w's scale): deepseek's E 64 and k 6 at the model's scale,
# Jamba's E 16 k 2, a ragged last stage with E 12, a weight of unit scale
PIECES_CASES = [(256, 192, 64, 6, None), (200, 256, 16, 2, None),
                (130, 72, 12, 3, None), (128, 128, 64, 6, 1.0)]


@pytest.mark.parametrize("case", PIECES_CASES,
                         ids=lambda c: "x".join(map(str, c[:4])))
def test_full_bwd_pieces_within_the_kernels_bound(case):
    """The fused kernel's arithmetic against the exact products: dx within
    2^-20 of sum_e |dl_e w_e| (six products: every term down to 2^-16 of
    a term kept; the five left out each at most 2^-24 of it, and six
    float32 roundings of the partial sums), dw within
    (stages + 8) 2^-24 of sum_t |x dl| (x exact in bf16, dl in three
    pieces to 2^-24, a float32 sum a stage); then, rounded to bf16, dx
    within the kernel's tolerance of the plain version, and dw within
    1e-5 of its largest value."""
    from repro_torch.kernels.moe_router import full_bwd_pieces, route_ref, \
        route_tokens_full_bwd_ref

    t, d, e, k, scale = case
    xn, wn, dG, dM = _inputs(t, d, e, k, seed=t + e)
    if scale is not None:
        wn = (wn * np.sqrt(d) * scale).astype(np.float32)
    x = torch.from_numpy(xn).to(torch.bfloat16)
    w = torch.from_numpy(wn)
    logits = x.float() @ w
    gates, idx, _, _ = route_ref(logits, top_k=k)
    dl, dx_p, dw_p = route_tokens_full_bwd_ref(
        x, w, logits, idx, gates, torch.from_numpy(dG), torch.from_numpy(dM))
    dx, dw = full_bwd_pieces(x, w, dl)
    exact_dx = dl.double() @ w.double().T
    exact_dw = x.double().T @ dl.double()
    s_dx = dl.double().abs() @ w.double().abs().T
    s_dw = x.double().abs().T @ dl.double().abs()
    assert bool(((dx.double() - exact_dx).abs() <= 2.0 ** -20 * s_dx).all())
    stages = -(-t // 64)
    assert bool(((dw.double() - exact_dw).abs()
                 <= (stages + 8) * 2.0 ** -24 * s_dw).all())
    _within(dx.to(torch.bfloat16), dx_p, BF16_REL, "dx")
    _within(dw, dw_p, 0.0, "dw")


def test_three_dx_products_leave_the_terms_past_2_to_the_16():
    """Why dx takes six products: the three largest (l1.w1, l1.w2, l2.w1)
    leave every term of 2^-16 (l1.w3, l2.w2, l3.w1), which reads ~1e-5 of
    the largest |dx| at deepseek's scale, as large as the tolerance's
    absolute part; the six leave ~2^-24."""
    from repro_torch.kernels.moe_router import route_ref, \
        route_tokens_full_bwd_ref
    from repro_torch.kernels.moe_router.ref import _bf16_pieces

    t, d, e, k = 1024, 256, 64, 6
    xn, wn, dG, dM = _inputs(t, d, e, k, seed=5)
    x = torch.from_numpy(xn).to(torch.bfloat16)
    w = torch.from_numpy(wn)
    logits = x.float() @ w
    gates, idx, _, _ = route_ref(logits, top_k=k)
    dl = route_tokens_full_bwd_ref(x, w, logits, idx, gates,
                                   torch.from_numpy(dG),
                                   torch.from_numpy(dM))[0]
    lp = [p.double() for p in _bf16_pieces(dl, 3)]
    wp = [p.double() for p in _bf16_pieces(w, 3)]
    exact = dl.double() @ w.double().T
    top = float(exact.abs().max())
    three = sum(lp[a] @ wp[b].T for a, b in ((1, 0), (0, 1), (0, 0)))
    six = three + sum(lp[a] @ wp[b].T for a, b in ((2, 0), (1, 1), (0, 2)))
    err3 = float((three - exact).abs().max()) / top
    err6 = float((six - exact).abs().max()) / top
    assert 1e-6 < err3 < 1e-4 and err6 < 1e-7, (err3, err6)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


PLAN_CASES = [
    ("deepseek train", (4096, 2048, 64, 6, torch.bfloat16),
     {"variant": "fused", "slices": 16, "ranges": 8, "stages_per_range": 8}),
    ("jamba", (4096, 8192, 16, 2, torch.bfloat16),
     {"variant": "fused", "slices": 64, "ranges": 2,
      "stages_per_range": 32}),
    ("one token", (1, 8, 4, 1, torch.bfloat16),
     {"variant": "fused", "slices": 1, "ranges": 1, "stages_per_range": 1}),
    ("ragged", (300, 200, 12, 3, torch.bfloat16),
     {"variant": "fused", "slices": 2, "ranges": 5, "stages_per_range": 1}),
    ("wide d", (4096, 20480, 64, 6, torch.bfloat16),
     {"variant": "fused", "slices": 160, "ranges": 1,
      "stages_per_range": 64}),
    ("65 stages over 8 ranges", (4160, 2048, 64, 6, torch.bfloat16),
     {"variant": "fused", "slices": 16, "ranges": 8, "stages_per_range": 9}),
]


@pytest.mark.parametrize("shape,want", [c[1:] for c in PLAN_CASES],
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_bwd_picks_fused_and_its_grid(shape, want):
    """bf16 x takes the fused kernel, its grid about one CTA an SM (132):
    slices of 128 values of d, token ranges of whole 64-row stages, every
    range non-empty."""
    from repro_torch.kernels.moe_router import plan_bwd

    t, d, e, k, dt = shape
    form = plan_bwd(_meta((t, d), dt), _meta((d, e), torch.float32),
                    top_k=k)
    assert form == want
    stages = -(-t // 64)
    assert form["ranges"] * form["stages_per_range"] >= stages \
        > (form["ranges"] - 1) * form["stages_per_range"]


@pytest.mark.parametrize("x_dtype,d,e,why", [
    (torch.float32, 2048, 64, "float32 x"),
    (torch.bfloat16, 2044, 64, "d 2044"),
    (torch.bfloat16, 2048, 30, "E 30")])
def test_plan_bwd_leaves_the_rest_to_logits(x_dtype, d, e, why):
    """float32 x (the f32 consistency cut's path), and shapes the fused
    kernel does not take, run the logits variant, and plan_bwd says why."""
    from repro_torch.kernels.moe_router import plan_bwd

    form = plan_bwd(_meta((256, d), x_dtype), _meta((d, e), torch.float32),
                    top_k=2)
    assert form["variant"] == "logits"
    assert why in form["reason"]


@pytest.mark.parametrize("args,err", [
    (((64, 128), torch.bfloat16, (128, 80), torch.float32, 2), ValueError),
    (((64, 128), torch.float16, (128, 16), torch.float32, 2), TypeError),
    (((64, 128), torch.bfloat16, (128, 16), torch.bfloat16, 2), TypeError),
    (((64, 128), torch.bfloat16, (128, 16), torch.float32, 0), ValueError),
    (((64, 128), torch.bfloat16, (128, 16), torch.float32, 17), ValueError),
    (((64, 128), torch.bfloat16, (64, 16), torch.float32, 2), ValueError),
    (((4, 64, 128), torch.bfloat16, (128, 16), torch.float32, 2),
     ValueError)])
def test_plan_bwd_refusals(args, err):
    """E over 64, types route_tokens refuses, top_k outside [1, E],
    mismatched or non-2-D shapes: raised, never planned."""
    from repro_torch.kernels.moe_router import plan_bwd

    xs, xdt, ws, wdt, k = args
    with pytest.raises(err):
        plan_bwd(_meta(xs, xdt), _meta(ws, wdt), top_k=k)


def test_bwd_variant_counts_reset_with_the_others():
    from repro_torch.kernels.moe_router import BWD_VARIANTS, FORMS, \
        VARIANTS, reset_variants

    assert set(BWD_VARIANTS) == {"fused", "logits"}
    BWD_VARIANTS["fused"] += 3
    VARIANTS["fused"] += 1
    FORMS["tile"] += 1
    reset_variants()
    assert BWD_VARIANTS == {"fused": 0, "logits": 0}
    assert not any(VARIANTS.values()) and not any(FORMS.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wants", ["dx", "dw", "both"])
def test_route_tokens_function_on_the_cpu_asks_for_what_it_needs(dtype,
                                                                  wants):
    """route_tokens' Function on the CPU (the plain backward) equals
    autograd of route_tokens_ref with x, w or both requiring a gradient;
    a tensor that requires none gets none."""
    from repro_torch.kernels.moe_router import route_tokens, route_tokens_ref

    xn, wn, dG, _ = _inputs(70, 40, 16, 3, seed=9, pad=6)
    dt = getattr(torch, dtype)
    grads = []
    for fn in (route_tokens, route_tokens_ref):
        x = torch.from_numpy(xn).to(dt).requires_grad_(wants != "dw")
        w = torch.from_numpy(wn).requires_grad_(wants != "dx")
        g, idx, pos, aux = fn(x, w, top_k=3, group_size=32)
        (g * torch.from_numpy(dG)).sum().add(
            aux["mean_prob"].square().sum()).backward()
        grads.append((x.grad, w.grad, idx))
    assert torch.equal(grads[0][2], grads[1][2])
    for got, want in zip(grads[0][:2], grads[1][:2]):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype
            _within(got, want, BF16_REL if got.dtype == torch.bfloat16
                    else 1e-5)


class _Stream:
    cuda_stream = 0


def _cpu_args(dtype, seed=2):
    """Tensors route_tokens' backward gets, on the CPU: x, w, the logits,
    idx, gates, dG, dM."""
    from repro_torch.kernels.moe_router import route_ref

    xn, wn, dG, dM = _inputs(130, 256, 16, 2, seed=seed)
    x = torch.from_numpy(xn).to(dtype)
    w = torch.from_numpy(wn)
    logits = x.float() @ w
    gates, idx, _, _ = route_ref(logits, top_k=2)
    return x, w, logits, idx, gates, torch.from_numpy(dG), \
        torch.from_numpy(dM)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "dx", "dw"])
def test_fused_wrapper_calls_its_kernel_and_raises_on_failure(monkeypatch,
                                                              need):
    """With the kernel path forced on CPU tensors and the entry points
    stubbed, tokens_bwd on bf16 x calls the fused kernel once with its C
    signature's 21 arguments (null for an output not asked for; the plan's
    ranges and stages), counts one launch of moe_router_bwd and one
    ``fused``, and raises on the kernel's error code; the logits kernel
    and torch.matmul never run (no fallback)."""
    from repro_torch.kernels.interface import LAUNCHES, KernelType
    from repro_torch.kernels.moe_router import BWD_VARIANTS, ops

    calls = []

    def fused(*args):
        calls.append(args)
        assert len(args) == 21
        return 700                      # cudaErrorIllegalAddress

    def never():
        raise AssertionError("the logits kernel ran")

    args = _cpu_args(torch.bfloat16)
    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(ops, "_BWD_SCRATCH", {})
    monkeypatch.setattr(ops, "_bwd_fused_fn", lambda: fused)
    monkeypatch.setattr(ops, "_bwd_fn", never)
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda *a: never())
    launches = LAUNCHES.get("moe_router_bwd", 0)
    counted = dict(BWD_VARIANTS)
    with pytest.raises(RuntimeError, match="moe_router_bwd_hopper kernel "
                                           "launch failed: CUDA error 700"):
        ops.tokens_bwd(*args, need=need)
    assert LAUNCHES["moe_router_bwd"] == launches + 1
    assert BWD_VARIANTS == {"fused": counted["fused"] + 1,
                            "logits": counted["logits"]}
    (got,) = calls
    assert (got[8] is None) == (not need[0])
    assert (got[9] is None) == (not need[1])
    assert got[1] == 256 and got[13:20] == (130, 256, 16, 2, 1, 3, 1)


def test_fused_wrapper_raises_when_the_build_fails(monkeypatch):
    """A kernel that does not build raises out of the backward; nothing
    else runs in its place."""
    from repro_torch.kernels.interface import KernelType
    from repro_torch.kernels.moe_router import ops

    def no_build():
        raise RuntimeError("kernel build failed: moe_router_bwd_hopper")

    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(ops, "_BWD_SCRATCH", {})
    monkeypatch.setattr(ops, "_bwd_fused_fn", no_build)
    monkeypatch.setattr(ops, "_bwd_fn", lambda: pytest.fail("logits ran"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        ops.tokens_bwd(*_cpu_args(torch.bfloat16))


def test_logits_variant_for_float32_x(monkeypatch):
    """float32 x runs the logits variant: the dl kernel (stubbed to write
    the plain dl), then dl w^T and f32(x)^T dl; counted ``logits``; the
    fused kernel never runs. The result equals the plain version's."""
    from repro_torch.kernels.interface import KernelType
    from repro_torch.kernels.moe_router import BWD_VARIANTS, ops
    from repro_torch.kernels.moe_router.ref import route_tokens_bwd_ref, \
        route_tokens_full_bwd_ref

    args = _cpu_args(torch.float32)
    x, w, logits, idx, gates, dG, dM = args

    def dl_kernel(lg, ids, gt, dg, dm, dl, *rest):
        assert rest[-1] == 0 and rest[:3] == (130, 16, 2)
        dl.copy_(route_tokens_bwd_ref(logits, idx, gates, dG, dM))
        return 0

    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    # data_ptr() hands the tensor itself to the stub
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: self)
    monkeypatch.setattr(ops, "_bwd_fn", lambda: dl_kernel)
    monkeypatch.setattr(ops, "_bwd_fused_fn",
                        lambda: pytest.fail("the fused kernel ran"))
    before = dict(BWD_VARIANTS)
    dx, dw = ops.tokens_bwd(*args)
    assert BWD_VARIANTS == {"fused": before["fused"],
                            "logits": before["logits"] + 1}
    _, want_dx, want_dw = route_tokens_full_bwd_ref(*args)
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
