"""The port's backward of the MoE router and of the WKV-6 scan against the
JAX package on the CPU.

The reference has no custom VJP for either: it differentiates its XLA
``route_ref`` (``repro/kernels/moe_router/ref.py``), the router product
around it and its XLA ``wkv6_ref`` (``repro/kernels/rwkv6_scan/ref.py``,
a ``lax.scan`` checkpointed every 128 steps) with ``jax.grad``. Held
against ``jax.vjp`` of those, with cotangents drawn from numpy:

  * the repaired ``route_ref`` (its top-k mask no longer written in place
    on a tensor autograd saved): its outputs bit-equal to the in-place
    form's, and its autograd gradient;
  * ``route_tokens_bwd_ref``, the closed form the backward kernel
    ``moe_router_bwd`` computes, at E 64 and k 1, 2 and 6, renormalised
    and not, against autograd of ``route_tokens_ref`` and ``jax.vjp``;
    the ops' autograd Functions (``route_topk``, ``route_tokens``) on the
    CPU, which run it;
  * ``moe_apply``'s gradient with choices dropped over capacity and a
    padded last group, the router's choices compared first;
  * ``wkv6_bwd_ref``, the reverse scan the backward kernel
    ``rwkv6_scan_bwd`` computes, for r, k, v, w, u and the state: float32,
    and bf16 r/k/v with float32 w; t = 1, 17 and 130; a given state and
    a final-state cotangent; decays exactly 0 and 1; and the ``wkv``
    Function on the CPU;
  * ``wkv6_chunked_bwd``, the same gradient in the order of the chunked
    backward kernel ``rwkv6_scan_bwd_hopper``, against ``wkv6_bwd_ref``
    and ``jax.vjp`` at t = 1 .. 100 around the chunk of 16, and with the
    kernel's TF32 operand splits in bf16;
  * ``loss_fn(...).backward()`` of the reduced deepseek-moe-16b,
    dbrx-132b and rwkv6-7b.

Tolerances: float32 gradients within rtol 1e-5 / atol 1e-6 of the
largest (the two packages sum in different orders); the router's within
rtol 1e-5 / atol 1e-6 absolute, the cotangents being of unit scale: at
k = 1 renormalised the gates are exactly 1, so the gates' gradient is 0
up to each package's rounding of dG - sum dG * gates (~3e-7); the WKV
scan over
130 steps within 1e-5 of its largest gradient (its sums run over up to
130 steps and 64 keys); a bf16 gradient within one bf16 rounding (2^-7)
of each value plus 1e-5 of the largest; moe_apply within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels.moe_router.ref import route_ref as j_route_ref  # noqa: E402
from repro.kernels.rwkv6_scan.ref import wkv6_ref as j_wkv6_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402

BF16_REL = 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol=1e-5, atol=1e-6, msg="", scale=None):
    """got within rtol of each value plus atol of ``scale`` (default
    want's largest value)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, msg
    if scale is None:
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


def _close_router(got, want, msg=""):
    """A router gradient: rtol 1e-5, atol 1e-6 absolute (module
    docstring)."""
    _close(got, want, rtol=1e-5, atol=1e-6, msg=msg, scale=1.0)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _route_in_place(logits, *, top_k, renormalize=True):
    """``route_ref`` as it was before the repair: the top-k rounds mask the
    chosen expert with ``scatter_`` in place."""
    from repro_torch.kernels.moe_router.ref import NEG_INF, softmax_rows

    t, e = logits.shape
    probs = softmax_rows(logits.float())
    work = probs.clone()
    gs, ids = [], []
    gsum = torch.zeros(t, dtype=torch.float32)
    for _ in range(top_k):
        a = work.argmax(dim=-1, keepdim=True)
        g = work.gather(1, a)
        work.scatter_(1, a, NEG_INF)
        gs.append(g)
        ids.append(a)
        gsum = gsum + g[:, 0]
    gates = torch.cat(gs, dim=1).to(logits.dtype)
    if renormalize:
        gates = (gates.float() / gsum.clamp_min(1e-20)[:, None]) \
            .to(logits.dtype)
    idx = torch.cat(ids, dim=1)
    sel = torch.zeros(t, e, dtype=torch.float32)
    sel.scatter_(1, idx, 1.0)
    return gates, idx.to(torch.int32), probs, {
        "mean_prob": probs.sum(0) / t, "frac_tokens": sel.sum(0) / (t * top_k)}


def _logits(t, e, seed, tied=False):
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((t, e))).astype(np.float32)
    if tied:        # all-equal rows and a tied top-k boundary
        x[0::7] = 0.25
        x[2::7, :8] = 3.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,renorm", [(1, True), (6, True), (6, False)])
def test_route_ref_outputs_bit_equal_after_the_repair(dtype, k, renorm):
    from repro_torch.kernels.moe_router import route_ref

    x = torch.from_numpy(_logits(300, 64, 1, tied=True)).to(
        getattr(torch, dtype))
    got = route_ref(x, top_k=k, renormalize=renorm)
    want = _route_in_place(x, top_k=k, renormalize=renorm)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name in ("mean_prob", "frac_tokens"):
        assert torch.equal(got[3][name], want[3][name])


def _j_route_vjp(logits, dgates, dmean, k, renorm):
    def f(l):
        g, _, _, aux = j_route_ref(l, top_k=k, renormalize=renorm)
        return g, aux["mean_prob"]

    _, vjp = jax.vjp(f, jnp.asarray(logits))
    return np.asarray(vjp((jnp.asarray(dgates), jnp.asarray(dmean)))[0])


ROUTE_CASES = [(1, True), (2, True), (6, True), (1, False), (2, False),
               (6, False)]


@pytest.mark.parametrize("k,renorm", ROUTE_CASES)
def test_route_ref_gradient_matches_jax_vjp(k, renorm):
    from repro_torch.kernels.moe_router import route_ref

    lg = _logits(96, 64, 2)
    rng = np.random.default_rng(3)
    dG = rng.standard_normal((96, k)).astype(np.float32)
    dM = rng.standard_normal(64).astype(np.float32)
    x = torch.from_numpy(lg).requires_grad_()
    g, idx, _, aux = route_ref(x, top_k=k, renormalize=renorm)
    want_idx = np.asarray(j_route_ref(jnp.asarray(lg), top_k=k,
                                      renormalize=renorm)[1])
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    (g * torch.from_numpy(dG)).sum().add(
        (aux["mean_prob"] * torch.from_numpy(dM)).sum()).backward()
    _close_router(x.grad, _j_route_vjp(lg, dG, dM, k, renorm))


@pytest.mark.parametrize("k,renorm", ROUTE_CASES)
def test_route_tokens_bwd_ref_matches_autograd_and_jax(k, renorm):
    """The closed form against autograd of ``route_tokens_ref`` (dx = dl
    w^T, dw = x^T dl) and against ``jax.vjp`` of the reference's
    ``route_ref`` on the same logits."""
    from repro_torch.kernels.moe_router import (route_tokens_bwd_ref,
                                                route_tokens_ref)

    rng = np.random.default_rng(4)
    t, d, e = 80, 48, 64
    xn = rng.standard_normal((t, d)).astype(np.float32)
    wn = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    dG = rng.standard_normal((t, k)).astype(np.float32)
    dM = rng.standard_normal(e).astype(np.float32)
    x = torch.from_numpy(xn).requires_grad_()
    w = torch.from_numpy(wn).requires_grad_()
    g, idx, _, aux = route_tokens_ref(x, w, top_k=k, renormalize=renorm,
                                      group_size=32)
    (g * torch.from_numpy(dG)).sum().add(
        (aux["mean_prob"] * torch.from_numpy(dM)).sum()).backward()
    logits = x.detach() @ w.detach()
    dl = route_tokens_bwd_ref(logits, idx, g.detach(), torch.from_numpy(dG),
                              torch.from_numpy(dM), renormalize=renorm)
    assert dl.dtype == torch.float32 and dl.shape == (t, e)
    _close_router(dl @ w.detach().T, x.grad)
    _close_router(x.detach().T @ dl, w.grad)
    _close_router(dl, _j_route_vjp(_np(logits), dG, dM, k, renorm))
    # a zero cotangent of one output: its term drops out
    only_m = route_tokens_bwd_ref(logits, idx, g.detach(),
                                  torch.zeros(t, k), torch.from_numpy(dM),
                                  renormalize=renorm)
    only_g = route_tokens_bwd_ref(logits, idx, g.detach(),
                                  torch.from_numpy(dG), torch.zeros(e),
                                  renormalize=renorm)
    _close_router(only_m + only_g, dl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_topk_function_on_the_cpu(dtype):
    """route_topk's autograd Function on the CPU (the plain backward)
    equals autograd of route_ref on the float32 logits, its gradient in
    the logits' type; the ids and frac_tokens carry no gradient. In bf16
    the cotangent of the bf16 gates is bf16, and the Function's gates are
    rounded to bf16 (2^-8), which enters dl through the renormalisation's
    sum: within 2^-7 of each value plus 2^-7 of the largest."""
    from repro_torch.kernels.moe_router import route_ref, route_topk

    dt = getattr(torch, dtype)
    lg = torch.from_numpy(_logits(70, 16, 5)).to(dt)
    rng = np.random.default_rng(6)
    dG = torch.from_numpy(rng.standard_normal((70, 3)).astype(np.float32))
    dM = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    x = lg.clone().requires_grad_()
    g, idx, aux = route_topk(x, top_k=3)
    assert not idx.requires_grad and not aux["frac_tokens"].requires_grad
    (g.float() * dG).sum().add((aux["mean_prob"] * dM).sum()).backward()
    assert x.grad.dtype == dt
    x32 = lg.float().requires_grad_()
    g32, idx32, _, aux32 = route_ref(x32, top_k=3)
    assert torch.equal(idx, idx32)
    (g32 * dG.to(dt).float()).sum().add(
        (aux32["mean_prob"] * dM).sum()).backward()
    if dtype == "float32":
        _close_router(x.grad, x32.grad)
    else:
        _close(x.grad, x32.grad, rtol=BF16_REL, atol=BF16_REL)


def test_route_tokens_function_on_the_cpu():
    from repro_torch.kernels.moe_router import route_tokens, route_tokens_ref

    rng = np.random.default_rng(7)
    xn = rng.standard_normal((50, 32)).astype(np.float32)
    wn = (rng.standard_normal((32, 8)) / 6).astype(np.float32)
    dG = torch.from_numpy(rng.standard_normal((50, 2)).astype(np.float32))
    out = []
    for fn in (route_tokens, route_tokens_ref):
        x = torch.from_numpy(xn).requires_grad_()
        w = torch.from_numpy(wn).requires_grad_()
        g, idx, pos, aux = fn(x, w, top_k=2, group_size=16)
        assert not pos.requires_grad and not idx.requires_grad
        (g * dG).sum().add(aux["mean_prob"].square().sum()).backward()
        out.append((x.grad, w.grad, idx, pos))
    _close_router(out[0][0], out[1][0])
    _close_router(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
    assert torch.equal(out[0][3], out[1][3])


def test_moe_apply_gradient_matches_jax_with_drops_and_padding(monkeypatch):
    """The reduced deepseek MoE layer (4 experts, top-2, a shared expert)
    with capacity factor 0.5 (capacity 2 of 8 tokens x 2 choices a group)
    on 2 x 13 tokens in groups of 8 (the last group padded by 6 rows):
    the router's choices are compared first (they must agree), choices
    are dropped over capacity, and the gradients of y and the aux loss
    in every parameter and in x match jax.vjp."""
    import dataclasses

    import repro_torch.models.moe as tmoe
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy

    jcfg = j_reduced("deepseek-moe-16b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    cfg = get_reduced_config("deepseek-moe-16b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(8)
    b, s, d, gs = 2, 13, jcfg.d_model, 8
    xn = rng.standard_normal((b, s, d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    daux = np.float32(3.0)

    rec = []
    orig = tmoe.route_topk

    def recorded(logits, **kw):
        out = orig(logits, **kw)
        rec.append((logits.detach().numpy().copy(), out[1].numpy().copy()))
        return out

    monkeypatch.setattr(tmoe, "route_topk", recorded)
    live = jax.tree.map(lambda a: a, p)
    leaves = {}

    def mark(tree, path=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                mark(val, f"{path}/{key}")
            else:
                tree[key] = val.clone().requires_grad_()
                leaves[f"{path}/{key}"] = tree[key]

    mark(live)
    x = torch.from_numpy(xn).requires_grad_()
    y, aux = tmoe.moe_apply(live, cfg, x, group_size=gs)
    # the choices first: the reference's route on the same padded logits
    (logits, idx), = rec
    _, jidx, _ = jmoe.route_topk(jnp.asarray(logits), top_k=cfg.moe.top_k)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    from repro_torch.kernels.moe_router import positions_ref

    pos = positions_ref(torch.from_numpy(idx), gs, cfg.moe.num_experts)
    cap = tmoe._capacity(gs, cfg.moe.num_experts, cfg.moe.top_k, 0.5)
    assert int((pos[:b * s] >= cap).sum()) > 0, "no choice was dropped"
    assert logits.shape[0] == 32 > b * s          # a padded last group
    (y * torch.from_numpy(dy)).sum().add(aux * float(daux)).backward()

    def jf(params, xx):
        return jmoe.moe_apply(params, jcfg, xx, group_size=gs)

    (jy, jaux), vjp = jax.vjp(jf, jp, jnp.asarray(xn))
    _close(y, jy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jgp, jgx = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    _close(x.grad, jgx, atol=1e-5, rtol=1e-5, msg="x")
    flat = {}

    def walk(tree, path=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{path}/{key}")
            else:
                flat[f"{path}/{key}"] = val

    walk(jgp)
    assert set(flat) == set(leaves)
    for name, leaf in leaves.items():
        _close(leaf.grad, flat[name], atol=1e-5, rtol=1e-5, msg=name)
    assert float(leaves["/router"].grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the WKV-6 scan
# ---------------------------------------------------------------------------

def _wkv_inputs(b, t, h, n, seed, strong=False):
    """r, k, v (b, t, h, n) ~ 0.3 N(0, 1), w in (0, 1) (``strong``: with
    entries exactly 0 and exactly 1), u ~ 0.1 N(0, 1), a nonzero state,
    and the cotangents dout ~ N(0, 1) and dstate ~ N(0, 1): float32
    numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.standard_normal((b, t, h, n)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, t, h, n))
                       * (2.0 if strong else 1.0) - (0 if strong else 3)))
    if strong:
        w[..., ::7] = 0.0
        w[:, 3::5, :, 1::6] = 1.0
    u = 0.1 * rng.standard_normal((h, n))
    s0 = rng.standard_normal((b, h, n, n))
    dout = rng.standard_normal((b, t, h, n))
    ds = rng.standard_normal((b, h, n, n))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, s0, dout, ds))


def _j_wkv_vjp(r, k, v, w, u, s0, dout, ds, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = [jnp.asarray(a).astype(jdt) for a in (r, k, v)] + [
        jnp.asarray(w), jnp.asarray(u)] + ([] if s0 is None
                                          else [jnp.asarray(s0)])

    def f(*a):
        return j_wkv6_ref(*a[:5], None if s0 is None else a[5])

    (out, st), vjp = jax.vjp(f, *args)
    cot = (jnp.asarray(dout).astype(out.dtype), jnp.asarray(ds))
    return vjp(cot)


WKV_CASES = [  # (b, t, h, n, given state, final cotangent, strong decays)
    (2, 1, 2, 16, True, True, False),
    (2, 17, 2, 16, True, True, False),
    (2, 17, 3, 32, False, False, False),
    (1, 130, 2, 16, True, True, False),
    (1, 130, 1, 64, False, True, True),
    (2, 17, 2, 16, True, False, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: (
    f"b{c[0]}t{c[1]}h{c[2]}n{c[3]}" + ("-state" if c[4] else "")
    + ("-dstate" if c[5] else "") + ("-w01" if c[6] else "")))
def test_wkv6_bwd_ref_matches_jax_vjp(case, dtype):
    """Gradients of r, k, v (in r's type), w (float32), u and the state
    against jax.vjp of the reference's wkv6_ref."""
    from repro_torch.kernels.rwkv6_scan import wkv6_bwd_ref

    b, t, h, n, state, final, strong = case
    r, k, v, w, u, s0, dout, ds = _wkv_inputs(b, t, h, n, 9 + t, strong)
    s0 = s0 if state else None
    ds = ds if final else np.zeros_like(ds)     # what autograd hands in
    want = _j_wkv_vjp(r, k, v, w, u, s0, dout, ds, dtype)
    dt = getattr(torch, dtype)
    tr, tk, tv = (torch.from_numpy(a).to(dt) for a in (r, k, v))
    # the cotangent in the output's type, as autograd hands it
    tdo = torch.from_numpy(np.asarray(
        jnp.asarray(dout).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32), np.float32)).to(dt)
    got = wkv6_bwd_ref(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u),
                       None if s0 is None else torch.from_numpy(s0), tdo,
                       torch.from_numpy(ds))
    assert [g.dtype for g in got] == [dt, dt, dt, torch.float32,
                                      torch.float32, torch.float32]
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    for name, g, wt in zip(names, got, list(want) + [None]):
        if wt is None:
            assert s0 is None and name == "dstate"
            continue
        if dtype == "bfloat16" and name in ("dr", "dk", "dv"):
            _close(g, wt, rtol=BF16_REL, atol=1e-5, msg=name)
        else:
            _close(g, wt, rtol=1e-5, atol=1e-5, msg=name)


# (t, given state, final cotangent, strong decays: w exactly 0 and 1, the
# kernel's operand splits in bf16): lengths around the chunk of 16
CHUNKED_BWD_CASES = [
    (t, state, state, strong, False) for t in (1, 15, 16, 17, 33, 100)
    for state in (True, False) for strong in (False, True)] + [
    (33, True, False, True, False), (33, False, True, False, False)] + [
    (t, state, state, strong, True) for t, state in ((17, True), (100, False),
                                                     (100, True))
    for strong in (False, True)]
WKV_BWD_TOL = 1e-5          # chip_smoke.py::WKV_BWD_TOL


@pytest.mark.parametrize("case", CHUNKED_BWD_CASES, ids=lambda c: (
    f"t{c[0]}" + ("-state" if c[1] else "") + ("-dstate" if c[2] else "")
    + ("-w01" if c[3] else "") + ("-split-bf16" if c[4] else "")))
def test_wkv6_chunked_bwd_matches_the_scan_and_jax(case):
    """ref.wkv6_chunked_bwd, the chunked backward kernel's order (chunks
    of 16, Z recurrences, prefix / suffix / pairwise decay products),
    against the port's reverse scan wkv6_bwd_ref and jax.vjp of the
    reference's wkv6_ref, at (2, t, 2, 64): float32 within rtol 1e-5 /
    atol 1e-6 of each gradient's largest value; with split_tf32 (the
    kernel's operand splits) and bf16 r, k, v, dout, against
    wkv6_bwd_ref within WKV_BWD_TOL of each scale, bf16 also within one
    bf16 rounding (2^-7) of each value, as chip_smoke.py holds the
    kernel."""
    from repro_torch.kernels.rwkv6_scan import wkv6_bwd_ref, wkv6_chunked_bwd

    t, state, final, strong, split = case
    r, k, v, w, u, s0, dout, ds = _wkv_inputs(2, t, 2, 64, 40 + t, strong)
    s0 = s0 if state else None
    ds = ds if final else np.zeros_like(ds)     # what autograd hands in
    dt = torch.bfloat16 if split else torch.float32
    tr, tk, tv, tdo = (torch.from_numpy(a).to(dt) for a in (r, k, v, dout))
    rest = (torch.from_numpy(w), torch.from_numpy(u),
            None if s0 is None else torch.from_numpy(s0))
    got = wkv6_chunked_bwd(tr, tk, tv, *rest, tdo, torch.from_numpy(ds),
                           split_tf32=split)
    want = wkv6_bwd_ref(tr, tk, tv, *rest, tdo, torch.from_numpy(ds))
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    assert [g.dtype for g in got] == [g.dtype for g in want]
    assert [g.shape for g in got] == [g.shape for g in want]
    if split:
        for name, g, wt in zip(names, got, want):
            scale = float(wt.float().abs().max())
            rel = BF16_REL if g.dtype == torch.bfloat16 else 0.0
            err = (g.float() - wt.float()).abs()
            assert bool((err <= rel * wt.float().abs()
                         + WKV_BWD_TOL * scale).all()), \
                (name, float(err.max()), scale)
        return
    for name, g, wt in zip(names, got, want):
        _close(g, wt, rtol=1e-5, atol=1e-6, msg=name)
    jwant = _j_wkv_vjp(r, k, v, w, u, s0, dout, ds, "float32")
    for name, g, wt in zip(names, got, jwant):  # no dstate without a state
        _close(g, wt, rtol=1e-5, atol=1e-6, msg=f"{name} vs jax")


def test_wkv_function_on_the_cpu():
    """wkv's autograd Function (the plain backward) against autograd of
    the plain forward, state given and not; a state written in place
    refuses a gradient."""
    from repro_torch.kernels.rwkv6_scan import wkv, wkv6_ref

    r, k, v, w, u, s0, dout, ds = _wkv_inputs(2, 19, 2, 16, 30, True)
    for state in (s0, None):
        grads = []
        for fn in (wkv, wkv6_ref):
            ins = [torch.from_numpy(a).requires_grad_()
                   for a in (r, k, v, w, u)]
            st = None if state is None else \
                torch.from_numpy(state).requires_grad_()
            out, s = fn(*ins, st)
            loss = (out * torch.from_numpy(dout)).sum() \
                + (s * torch.from_numpy(ds)).sum()
            grads.append(torch.autograd.grad(
                loss, ins + ([] if st is None else [st])))
        for a, b_ in zip(*grads):
            _close(a, b_)
    x = torch.from_numpy(r).requires_grad_()
    cache = torch.from_numpy(s0).clone()
    with pytest.raises(ValueError, match="in place"):
        wkv(x, *(torch.from_numpy(a) for a in (k, v, w, u)), cache,
            out_state=cache)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b",
                                  "rwkv6-7b", "yi-34b", "qwen1.5-32b"])
def test_loss_backward_runs_for_moe_and_rwkv(arch):
    """loss_fn(...).backward() of the reduced model, from the reference's
    parameters: its loss equals the reference's, every gradient is finite
    and equals jax.grad's, and the router / WKV / attention-bias leaves
    get one (the dense yi-34b and qwen1.5-32b: GQA, and qwen1.5's q/k/v
    biases)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.tokens import lm_batches
    from repro_torch.flat import tree_leaves
    from repro_torch.models import model as M

    jcfg = j_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = next(lm_batches(np.random.default_rng(0), 512, batch=2,
                            seq_len=16, steps=1))
    leaves = [x.requires_grad_() for _, x in tree_leaves(p)]
    loss = M.loss_fn(p, get_reduced_config(arch),
                     {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    jloss, jg = jax.value_and_grad(
        lambda q: JM.loss_fn(q, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    for (name, _), leaf in zip(tree_leaves(p), leaves):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
        _close(leaf.grad, want[name], rtol=1e-4, atol=1e-5, msg=name)
    names = [name for name, _ in tree_leaves(p)]
    key = {"rwkv6-7b": "decay_w0", "yi-34b": "wq",
           "qwen1.5-32b": "bq"}.get(arch, "router")
    hit = [leaf for name, leaf in zip(names, leaves) if key in name]
    assert hit and all(float(h.grad.abs().max()) > 0 for h in hit)
