"""The fused MoE router's plain versions and plan on the CPU.

``positions_ref`` (each choice's place in its expert's capacity buffer)
against the reference's own lines (``repro/models/moe.py``: one-hot,
cumsum over the (groups, group * k, E) selection, minus the selection,
within capacity), written out in ``jnp``; ``positions_blocked`` (the
same positions computed over blocks of rows with per-block tails, as
``csrc/moe_router_hopper.cu`` computes them) against ``positions_ref``;
``route_tokens(mode="torch")`` against its parts; the MoE layer's routing
seam on the CPU against ``route_tokens_ref``; ``moe_apply``'s capacity
step against the one-hot form the reference writes; which form ``plan``
picks per shape and type, and what ``route_tokens`` refuses.

Tolerances: none. Positions and ids are integers and must be equal; the
CPU path computes gates and statistics with the same operations in the
same order as ``route_tokens_ref``, so they are equal bit for bit; the
capacity step changes only how the same 0/1 values are formed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def _ids(t, e, k, seed, pad=0):
    """Router ids (t, k) of skewed logits (expert 0 favoured, so capacity
    overflows), the last ``pad`` rows zero logits as the padded tokens'
    (ids 0..k-1)."""
    from repro_torch.kernels.moe_router import route_ref

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    x[:, 0] += 1.5
    if pad:
        x[t - pad:] = 0.0
    return route_ref(torch.from_numpy(x), top_k=k)[1]


def _jax_capacity(idx, gs, e, cap):
    """The reference's lines (repro/models/moe.py:86-94) in jnp: the
    within-capacity selection (g, gs, k, E) and each choice's slot."""
    t, k = idx.shape
    g = t // gs
    sel = jax.nn.one_hot(jnp.asarray(idx).reshape(g, gs, k), e,
                         dtype=jnp.float32)
    sel_flat = sel.reshape(g, gs * k, e)
    pos_in_expert = jnp.cumsum(sel_flat, axis=1) - sel_flat
    pos_in_expert = pos_in_expert.reshape(g, gs, k, e)
    sel = sel * (pos_in_expert < cap)
    pos_idx = (pos_in_expert * sel).sum(-1).astype(jnp.int32)
    raw = (pos_in_expert * jax.nn.one_hot(
        jnp.asarray(idx).reshape(g, gs, k), e)).sum(-1).astype(jnp.int32)
    return np.asarray(sel), np.asarray(pos_idx), np.asarray(raw)


@pytest.mark.parametrize("gs", [4, 1024])
@pytest.mark.parametrize("e,k", [(4, 1), (16, 1), (16, 6), (64, 1),
                                 (64, 6)])
def test_positions_ref_matches_reference_lines(gs, e, k):
    """Two groups, the last 3 rows padded (zero logits), a capacity of
    gs * k / E (factor 1, at least k) that the skew overflows."""
    from repro_torch.kernels.moe_router import positions_ref

    t = 2 * gs
    idx = _ids(t, e, k, seed=gs + e + k, pad=3)
    cap = max(k, gs * k // e)
    pos = positions_ref(idx, gs, e)
    sel_r, slot_r, raw_r = _jax_capacity(idx.numpy(), gs, e, cap)
    np.testing.assert_array_equal(pos.numpy(), raw_r.reshape(t, k))
    # moe_apply's capacity step from pos: the reference's, value for value
    pos_g = pos.reshape(2, gs, k).long()
    keep = pos_g < cap
    sel = torch.nn.functional.one_hot(idx.reshape(2, gs, k).long(),
                                      e).float() * keep[..., None]
    np.testing.assert_array_equal(sel.numpy(), sel_r)
    np.testing.assert_array_equal(torch.where(keep, pos_g, 0).numpy(),
                                  slot_r)
    if gs == 1024 and e == 4:
        assert not bool(keep.all())          # capacity overflowed


@pytest.mark.parametrize("t,gs", [(1, 1), (70, 16), (70, 70), (100, 7),
                                  (1000, 1024), (300, 128)])
@pytest.mark.parametrize("rows", [2, 8, 32])
def test_positions_blocked_matches_positions_ref(t, gs, rows):
    """The kernel's blocked count (blocks of 2, 8, 32 rows: the decode's
    and the prefill's CTAs) against the plain cumsum, with groups smaller
    than a block, groups across blocks, and a last group cut short."""
    from repro_torch.kernels.moe_router import positions_ref
    from repro_torch.kernels.moe_router.ref import positions_blocked

    idx = _ids(t, 16, 3, seed=t + gs + rows)
    np.testing.assert_array_equal(
        positions_blocked(idx, gs, 16, rows).numpy(),
        positions_ref(idx, gs, 16).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", [True, False])
def test_route_tokens_torch_is_its_parts(dtype, renorm):
    """route_tokens(mode="torch") and on CPU tensors: f32 logits,
    route_topk's plain path, positions_ref of its ids -- bit for bit."""
    from repro_torch.kernels.moe_router import (positions_ref, route_tokens,
                                                route_topk)

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32)) \
        .to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)
                         / 8)
    logits = x.float() @ w
    g_w, i_w, a_w = route_topk(logits, top_k=4, renormalize=renorm)
    p_w = positions_ref(i_w, 32, 16)
    for mode in (None, "torch"):
        g, i, p, aux = route_tokens(x, w, top_k=4, renormalize=renorm,
                                    group_size=32, mode=mode)
        assert g.dtype == torch.float32
        assert i.dtype == p.dtype == torch.int32
        assert torch.equal(g, g_w) and torch.equal(i, i_w)
        assert torch.equal(p, p_w)
        for key in ("mean_prob", "frac_tokens"):
            assert torch.equal(aux[key], a_w[key])


def test_moe_route_seam_on_cpu_is_route_tokens_ref():
    """The MoE layer's seam on the CPU (the reference's cumsum, written in
    moe.py) gives route_tokens_ref's outputs on the group-padded tokens."""
    from repro_torch.kernels.moe_router import route_tokens_ref
    from repro_torch.models.moe import route

    rng = np.random.default_rng(4)
    xp = torch.from_numpy(rng.standard_normal((3 * 24, 32))
                          .astype(np.float32))
    xp[-5:] = 0.0                                   # padded rows
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    got = route(xp, w, top_k=2, group_size=24)
    want = route_tokens_ref(xp, w, top_k=2, group_size=24)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    assert torch.equal(got[2].to(torch.int32), want[2])
    for key in ("mean_prob", "frac_tokens"):
        assert torch.equal(got[3][key], want[3][key])


def test_moe_apply_capacity_matches_one_hot_form():
    """moe_apply against its earlier body, which masked the one-hot
    selection by the cumsum's positions (the reference's form), at a
    capacity factor that drops tokens; the same output bit for bit."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.moe_router import route_topk
    from repro_torch.models import layers
    from repro_torch.models.moe import moe_apply, moe_init

    cfg = get_reduced_config("deepseek-moe-16b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    p = moe_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 20, cfg.d_model))
                         .astype(np.float32))
    y, _ = moe_apply(p, cfg, x, group_size=16)

    m = cfg.moe
    e, k = m.num_experts, m.top_k
    xt = F.pad(x.reshape(40, -1), (0, 0, 0, 8))
    gates, idx, _ = route_topk(xt @ p["router"], top_k=k)
    gates = torch.where((torch.arange(48) < 40)[:, None], gates, 0.0)
    cap = max(k, int(16 * k / e * 0.5))
    sel = F.one_hot(idx.reshape(3, 16, k).long(), e).float()
    flat = sel.reshape(3, 16 * k, e)
    pie = (flat.cumsum(1) - flat).reshape(3, 16, k, e)
    sel = sel * (pie < cap)
    cap_onehot = F.one_hot((pie * sel).sum(-1).long(), cap).float()
    dispatch = torch.einsum("gske,gskc->gsec", sel, cap_onehot)
    combine = torch.einsum("gske,gskc->gsec",
                           sel * gates.reshape(3, 16, k)[..., None],
                           cap_onehot)
    assert float(dispatch.sum()) < 40 * k           # tokens were dropped
    ein = torch.einsum("gsec,gsd->gecd", dispatch, xt.reshape(3, 16, -1))
    ex = p["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", ein, ex["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", ein, ex["w_up"])
    out = torch.einsum("gecf,efd->gecd", h, ex["w_down"])
    want = torch.einsum("gsec,gecd->gsd", combine, out).reshape(48, -1)[:40]
    want = want + layers.swiglu_apply(p["shared"], x.reshape(40, -1))
    assert torch.equal(y.reshape(40, -1), want)


@pytest.mark.parametrize("t,d,dtype,want", [
    (4096, 2048, "bfloat16", ("tile", 64, 2, 64)),
    (4096, 2048, "float32", ("tile", 64, 2, 64)),
    (33, 2048, "bfloat16", ("tile", 64, 2, 1)),
    (1000, 256, "float32", ("tile", 64, 2, 16)),
    (32, 2048, "bfloat16", ("split", 64, 16, 1)),
    (4, 2048, "bfloat16", ("split", 64, 16, 1)),
    (4, 256, "bfloat16", ("split", 64, 4, 1)),
    (1, 8, "float32", ("split", 64, 2, 1)),
])
def test_plan_picks_form_by_tokens(t, d, dtype, want):
    """The tile form for prefills (clusters of 2 CTAs over 64-token
    tiles), the split form for t <= 32 (a 64-token tile, d split over 2 to
    16 CTAs, one per 64 values); a pure function of shapes and types, asked here with
    meta-device tensors at the served shapes."""
    from repro_torch.kernels.moe_router import plan

    x = torch.empty((t, d), dtype=getattr(torch, dtype), device="meta")
    w = torch.empty((d, 64), device="meta")
    f = plan(x, w, top_k=6, group_size=1024)
    assert (f["form"], f["block_tokens"], f["cluster"], f["clusters"]) \
        == want
    assert f["variant"] == "fused"
    # what the kernel takes: at most 32 rows a CTA, a power-of-two cluster
    assert f["block_tokens"] // f["cluster"] <= 32
    assert f["cluster"] & (f["cluster"] - 1) == 0 and f["cluster"] <= 16


@pytest.mark.parametrize("t,want", [(4096, ("tile", 2, 64)),
                                    (4, ("split", 16, 1))])
def test_plan_at_jamba_shapes(t, want):
    """Jamba's MoE (d 8,192, 16 experts, top-2): its prefill's 4,096
    tokens in the tile form, a decode step's 4 in the split form, the
    cluster of 16 CTAs spanning 8 chunks of 64 values of d each."""
    from repro_torch.kernels.moe_router import plan

    f = plan(torch.empty((t, 8192), dtype=torch.bfloat16, device="meta"),
             torch.empty((8192, 16), device="meta"), top_k=2,
             group_size=min(t, 1024))
    assert (f["form"], f["cluster"], f["clusters"]) == want


def test_forms_count_with_the_variants():
    """``FORMS`` holds one count per form of the fused kernel, and
    ``reset_variants`` sets it to 0 with ``VARIANTS``."""
    from repro_torch.kernels import moe_router

    assert set(moe_router.FORMS) == {"tile", "split"}
    moe_router.FORMS["split"] += 3
    moe_router.VARIANTS["fused"] += 3
    moe_router.reset_variants()
    assert moe_router.FORMS == {"tile": 0, "split": 0}
    assert moe_router.VARIANTS == {"fused": 0, "logits": 0}


def test_route_tokens_checks():
    from repro_torch.kernels.moe_router import plan, route_tokens

    x = torch.zeros(8, 64)
    w = torch.zeros(64, 16)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="at most|up to"):
        plan(torch.empty(8, 64, **meta), torch.empty(64, 68, **meta),
             top_k=2, group_size=8)
    with pytest.raises(ValueError, match="multiple of 4"):
        plan(torch.empty(8, 64, **meta), torch.empty(64, 6, **meta),
             top_k=2, group_size=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        plan(torch.empty(8, 60, **meta), torch.empty(60, 16, **meta),
             top_k=2, group_size=8)
    with pytest.raises(TypeError, match="float32 router"):
        route_tokens(x, w.bfloat16(), top_k=2, group_size=8)
    with pytest.raises(TypeError, match="bfloat16 x"):
        route_tokens(x.half(), w, top_k=2, group_size=8)
    with pytest.raises(ValueError, match="tokens, d"):
        route_tokens(x, w[:32], top_k=2, group_size=8)
    with pytest.raises(ValueError, match="tokens, d"):
        route_tokens(x[0], w, top_k=2, group_size=8)
    with pytest.raises(ValueError, match="top_k"):
        route_tokens(x, w, top_k=17, group_size=8)
    with pytest.raises(ValueError, match="group_size"):
        route_tokens(x, w, top_k=2, group_size=0)
    with pytest.raises(ValueError, match="at least one"):
        route_tokens(x[:0], w, top_k=2, group_size=8)
    with pytest.raises(ValueError, match="cuda"):
        route_tokens(x, w, top_k=2, group_size=8, mode="cuda")
    # the plain version takes what the kernel does not (E > 64)
    g, i, p, _ = route_tokens(torch.randn(8, 64), torch.randn(64, 80),
                              top_k=3, group_size=4)
    assert g.shape == i.shape == p.shape == (8, 3)
