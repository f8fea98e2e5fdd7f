"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro/roofline/{analysis,hlo_analysis}.py``), on the CPU.

* ``model_flops_train`` / ``model_flops_decode`` for every architecture:
  exactly the reference's; ``Roofline.summary()`` the same text.
* The op counter's FLOPs of the paper DNN's forward and backward at a
  batch of 32: equal to ``analyze_hlo_text`` on the reference's compiled
  CPU HLO of the same value-and-grad, and to the products' 2 m n k
  written out.
* Counter edge cases: an elementwise op moves its inputs plus its output,
  a view nothing, an in-place or index write its region; live bytes
  count storages, not views, and fall when a tensor dies.
* Every kernel seam, on real CPU tensors and on fake ones: one launch of
  its family recording ``roofline.kernels``' work, and nothing of the
  plain version beneath it (the real call's counts equal the fake call's,
  which runs nothing); its fake outputs have the plain version's shapes
  and dtypes.
* ``roofline.kernels`` reproduces PERF.md's kernel-table bounds at the
  table's shapes, to the printed digits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    from repro_torch.configs import get_config
    from repro_torch.roofline import model_flops_decode, model_flops_train

    for tokens in (1, 4096 * 256):
        assert model_flops_train(get_config(arch), tokens) == \
            JA.model_flops_train(j_config(arch), tokens)
        assert model_flops_decode(get_config(arch), tokens) == \
            JA.model_flops_decode(j_config(arch), tokens)


def test_summary_text_matches_the_reference():
    from repro_torch.roofline import Roofline

    nums = dict(flops=3.1e15, hbm_bytes=2.2e13, collective_bytes=0.0,
                chips=1, compute_s=3.12, memory_s=6.57, collective_s=0.0,
                dominant="memory", model_flops=2.2e15, useful_ratio=0.71,
                collectives={})
    assert Roofline(**nums).summary() == JA.Roofline(**nums).summary()


def test_analyze_divides_each_unit_by_its_peak():
    from repro_torch.launch import mesh
    from repro_torch.roofline import analyze

    counts = {"flops": 4e12, "hbm_bytes": 6.7e9, "collective_bytes": 0.0,
              "collective_bytes_by_kind": {},
              "ops_by_unit": {"bf16": 989e12, "tf32": 0.0, "f32": 67e12,
                              "exp": mesh.EXP_RATE}}
    roof = analyze(counts, model_flops=2e12)
    assert roof.compute_s == pytest.approx(3.0)
    assert roof.memory_s == pytest.approx(2e-3)
    assert roof.dominant == "compute" and roof.useful_ratio == 0.5


def test_dnn_flops_match_the_hlo_walker():
    """Forward and backward of the paper DNN (60 -> 64 -> 32 -> 10) at a
    batch of 32: three forward products, the three weight gradients and
    the two activation gradients the loss needs (x takes none)."""
    from repro.configs.paper_dnn import CONFIG as JD
    from repro.models import paper_models as JPM
    from repro.roofline.hlo_analysis import analyze_hlo_text
    from repro_torch.configs.paper_dnn import CONFIG as PD
    from repro_torch.models import paper_models as PM
    from repro_torch.roofline.op_analysis import analyze_ops

    b = 32
    rng = np.random.default_rng(0)
    params = JPM.init_params(jax.random.PRNGKey(0), JD)
    x = rng.standard_normal((b, 60)).astype(np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    step = jax.jit(jax.value_and_grad(
        lambda p, bt: JPM.loss_fn(p, JD, bt)))
    hlo = step.lower(params, {"x": x, "y": y}).compile().as_text()
    want = analyze_hlo_text(hlo)["flops"]

    tp = {k: {kk: torch.tensor(np.asarray(vv))[None].requires_grad_()
              for kk, vv in v.items()} for k, v in params.items()}
    leaves = [t for v in tp.values() for t in v.values()]
    batch = {"x": torch.tensor(x)[None], "y": torch.tensor(y)[None]}

    def grads():
        return torch.autograd.grad(PM.loss_fn(tp, PD, batch).sum(), leaves)

    got = analyze_ops(grads)
    dims = [(60, 64), (64, 32), (32, 10)]
    written = sum(2 * 2 * b * i * o for i, o in dims) \
        + sum(2 * b * i * o for i, o in dims[1:])
    assert got["flops"] == want == written
    assert got["ops_by_unit"]["f32"] == written
    assert got["kernels"] == {} and got["collective_bytes"] == 0


def test_counter_bytes_views_and_liveness():
    from repro_torch.roofline.op_analysis import OpCounter

    a, b = torch.ones(64, 32), torch.ones(64, 32)
    row = 32 * 4
    with OpCounter() as c:
        s = a + b                                   # 2 reads + 1 write
    assert c.hbm_bytes == 3 * 64 * row and c.flops == 0
    with OpCounter() as c:
        v = a.t()[3:10]                             # views: nothing moves
        v2 = a[2:5].view(-1).reshape(32, 3)
    assert c.hbm_bytes == 0 and c.live_bytes == 0 and c.aten_ops == 5
    head = a[:4]
    with OpCounter() as c:
        head.add_(1.0)                              # its region read, written
    assert c.hbm_bytes == 2 * 4 * row
    with OpCounter() as c:
        a[5:6].copy_(b[:1])                         # src read, region written
    assert c.hbm_bytes == 2 * row
    idx, vals = torch.tensor([1, 2]), torch.zeros(2, 32)
    with OpCounter() as c:
        a.index_put_((idx,), vals)                  # ids, values, the rows
    assert c.hbm_bytes == 16 + 2 * row + 2 * row
    with OpCounter() as c:
        c.track(a)
        t = torch.empty(1000)                       # 4,000 bytes live
        tv = t[10:]                                 # a view: no more
        assert c.live_bytes == 64 * row + 4000
        del t, tv
        assert c.live_bytes == 64 * row
        u = torch.empty(10)
    assert c.peak_bytes == 64 * row + 4000
    del s, v, v2, u


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _seam_cases():
    """(label, family, inputs(maker), call(*inputs), work) of every seam:
    ``maker(shape, dtype, kind)`` makes an input; calls run without a
    gradient (the backward seams are called directly)."""
    from repro_torch.kernels import compress as C
    from repro_torch.kernels.flash_attention import attention, attention_bwd
    from repro_torch.kernels.mamba_scan import ops as MS
    from repro_torch.kernels.moe_router import route_tokens, route_topk
    from repro_torch.kernels.moe_router.ops import logits_bwd, tokens_bwd
    from repro_torch.kernels.prox_update import prox_sgd, prox_step_
    from repro_torch.kernels.quantize import quantize_int8
    from repro_torch.kernels.rwkv6_scan import ops as RS
    from repro_torch.kernels.segments import segments
    from repro_torch.kernels.tier_update import tier_update
    from repro_torch.roofline import kernels as W

    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    segs = segments((30, 50), (3, 5))
    bs, cols = 3, 88                          # rows padded past the leaves

    def comp(name, ops, call, **kw):
        return (name, name, ops, call,
                W.compress(name, bs, cols, 80, 2, segs.rows, **kw))

    att = dict(causal=True, window=0, q_offset=0, q_itemsize=2,
               kv_itemsize=2)
    cases = [
        ("prox_sgd momentum", "prox_update",
         lambda T: (T((6, 5), bf16), T((6, 5), bf16), T((6, 5), bf16),
                    T((6, 5), f32)),
         lambda t, g, a, m: prox_sgd(t, g, a, m, alpha=0.1, lam=0.5,
                                     momentum=0.9),
         W.prox_update(1, 30, itemsize=2, anchor_rows=1, momentum=True)),
        ("prox_step_ per config", "prox_update",
         lambda T: (T((12, 7), f32), T((12, 7), f32), T((4, 7), f32),
                    T((2,), f32, "pos"), T((2,), f32, "pos")),
         lambda t, g, a, al, lm: prox_step_(t, g, a, alpha=al, lam=lm),
         W.prox_update(12, 7, itemsize=4, anchor_rows=4, groups=2)),
        ("tier_update", "tier_update",
         lambda T: (T((6, 5), bf16), T((6, 5), bf16), T((6, 5), bf16)),
         lambda w, x, t: tier_update(w, x, t, eta=0.03, lam=0.5, gamma=1.5,
                                     beta=0.3),
         W.tier_update(30, 2)),
        comp("ef_topk", lambda T: (T((bs, cols), f32), T((bs, cols), f32),
                                   T((bs, 2), f32, "pos")),
             lambda d, e, th: C.ef_topk(d, e, segs, thresh=th)),
        comp("ef_randk", lambda T: (T((bs, cols), f32, "pos"),
                                    T((bs, cols), f32), T((bs, cols), f32),
                                    T((bs, 2), f32, "pos")),
             lambda u, d, e, th: C.ef_randk(u, d, e, segs, thresh=th)),
        comp("topk", lambda T: (T((bs, cols), f32), T((bs, 2), f32, "pos")),
             lambda v, th: C.topk(v, segs, thresh=th)),
        comp("randk", lambda T: (T((bs, cols), f32, "pos"),
                                 T((bs, cols), f32), T((bs, 2), f32, "pos")),
             lambda u, v, th: C.randk(u, v, segs, thresh=th)),
        comp("ef_sign", lambda T: (T((bs, cols), f32), T((bs, cols), f32),
                                   T((bs, 2), f32, "pos")),
             lambda d, e, sc: C.ef_sign(d, e, segs, scales=sc)),
        comp("sign", lambda T: (T((bs, cols), f32), T((bs, 2), f32, "pos")),
             lambda v, sc: C.sign(v, segs, scales=sc)),
        comp("ef_int8", lambda T: (T((bs, cols), f32), T((bs, cols), f32),
                                   T((bs, cols), f32, "pos")),
             lambda d, e, nz: C.ef_int8(d, e, nz, segs)),
        comp("quantize", lambda T: (T((bs, cols), f32),
                                    T((1, cols), f32, "pos")),
             lambda v, nz: quantize_int8(v, nz.expand(bs, cols), segs),
             noise_rows=1),
        ("attention", "flash_attention",
         lambda T: (T((2, 16, 4, 64), bf16), T((2, 16, 2, 64), bf16),
                    T((2, 16, 2, 64), bf16)),
         lambda q, k, v: attention(q, k, v),
         W.attention(2, 16, 16, 4, 2, 64, **att)),
        ("attention backward", "flash_attention_bwd",
         lambda T: (T((2, 16, 4, 64), bf16), T((2, 16, 2, 64), bf16),
                    T((2, 16, 2, 64), bf16), T((2, 16, 4, 64), bf16),
                    T((2, 4, 16), f32), T((2, 16, 4, 64), bf16)),
         lambda q, k, v, o, lse, do: attention_bwd(q, k, v, o, lse, do),
         W.attention_bwd(2, 16, 16, 4, 2, 64, causal=True, window=0,
                         q_offset=0, q_itemsize=2, kv_itemsize=2)),
        ("route_tokens", "moe_router",
         lambda T: (T((40, 32), bf16), T((32, 8), f32)),
         lambda x, w: route_tokens(x, w, top_k=2, group_size=16),
         W.moe_router(40, 32, 8, 2, x_itemsize=2)),
        ("tokens_bwd", "moe_router_bwd",
         lambda T: (T((40, 32), bf16), T((32, 8), f32), T((40, 8), f32),
                    T((40, 2), i32, "ids"), T((40, 2), f32, "pos"),
                    T((40, 2), f32), T((8,), f32)),
         lambda x, w, lg, idx, g, dg, dm: tokens_bwd(x, w, lg, idx, g, dg,
                                                     dm),
         W.moe_router_bwd(40, 32, 8, 2, x_itemsize=2)),
        ("route_topk", "moe_router",
         lambda T: (T((40, 8), f32),),
         lambda lg: route_topk(lg, top_k=2),
         W.route_topk(40, 8, 2)),
        ("logits_bwd", "moe_router_bwd",
         lambda T: (T((40, 8), f32), T((40, 2), i32, "ids"),
                    T((40, 2), f32, "pos"), T((40, 2), f32), T((8,), f32)),
         lambda lg, idx, g, dg, dm: logits_bwd(lg, idx, g, dg, dm),
         W.route_topk_bwd(40, 8, 2)),
        ("wkv", "rwkv6_scan",
         lambda T: (T((2, 9, 2, 16), bf16), T((2, 9, 2, 16), bf16),
                    T((2, 9, 2, 16), bf16), T((2, 9, 2, 16), f32, "decay"),
                    T((2, 16), f32), T((2, 2, 16, 16), f32)),
         lambda r, k, v, w, u, s: RS.wkv(r, k, v, w, u, s),
         W.rwkv6_scan(2, 9, 2, 16, itemsize=2, state=True)),
        ("wkv_bwd", "rwkv6_scan_bwd",
         lambda T: (T((2, 9, 2, 16), bf16), T((2, 9, 2, 16), bf16),
                    T((2, 9, 2, 16), bf16), T((2, 9, 2, 16), f32, "decay"),
                    T((2, 16), f32), T((2, 9, 2, 16), bf16),
                    T((2, 2, 16, 16), f32)),
         lambda r, k, v, w, u, do, ds: RS.wkv_bwd(r, k, v, w, u, None, do,
                                                  ds),
         W.rwkv6_scan_bwd(2, 9, 2, 16, itemsize=2, state=False)),
        ("scan", "mamba_scan",
         lambda T: (T((2, 20, 8), bf16), T((2, 20, 8), bf16, "pos"),
                    T((2, 20, 16), bf16), T((2, 20, 16), bf16),
                    T((8, 16), f32, "neg")),
         lambda xc, dt, b, c, a: MS.scan(xc, dt, b, c, a),
         W.mamba_scan(2, 20, 8, 16, itemsize=2, backward=False,
                      state=False)),
        ("scan_bwd", "mamba_scan_bwd",
         lambda T: (T((2, 20, 8), bf16), T((2, 20, 8), bf16, "pos"),
                    T((2, 20, 16), bf16), T((2, 20, 16), bf16),
                    T((8, 16), f32, "neg"), T((2, 2, 8, 16), f32),
                    T((2, 20, 8), bf16), T((2, 8, 16), f32)),
         lambda xc, dt, b, c, a, sn, dy, dh: MS.scan_bwd(
             xc, dt, b, c, a, sn, dy, dh, want_dh0=True),
         W.mamba_scan(2, 20, 8, 16, itemsize=2, backward=True, state=True,
                      final=True)),
    ]
    return cases


SEAM_LABELS = [c[0] for c in _seam_cases()]


def _maker(fake_mode=None):
    gen = torch.Generator().manual_seed(0)

    def make(shape, dtype, kind="normal"):
        if fake_mode is not None:
            with fake_mode:
                return torch.empty(shape, dtype=dtype)
        if kind == "ids":
            return torch.stack([torch.randperm(8, generator=gen)[:shape[1]]
                                for _ in range(shape[0])]).to(dtype)
        x = torch.randn(shape, generator=gen)
        x = {"pos": x.abs() + 0.1, "neg": -(x.abs() + 0.5),
             "decay": torch.sigmoid(x)}.get(kind, x)
        return x.to(dtype)
    return make


@pytest.mark.parametrize("label", SEAM_LABELS)
def test_seam_counts_its_work_once_and_no_plain_op(label):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.op_analysis import analyze_ops

    _, family, inputs, call, work = next(c for c in _seam_cases()
                                         if c[0] == label)
    real_in = inputs(_maker())
    with torch.no_grad():
        real_out = call(*real_in)
        real = analyze_ops(call, *real_in)
    fm = FakeTensorMode()
    fake_in = inputs(_maker(fm))
    with torch.no_grad(), fm:
        fake_out = call(*fake_in)
        fake = analyze_ops(call, *fake_in)
    want = {family: {"launches": 1, "bytes": work.bytes,
                     "flops": work.flops,
                     "exponentials": work.exponentials}}
    assert real["kernels"] == fake["kernels"] == want
    for key in ("flops", "hbm_bytes", "aten_ops", "ops_by_unit"):
        assert real[key] == fake[key], key
    assert real["hbm_bytes"] >= work.bytes and real["flops"] == work.flops
    got = [(tuple(t.shape), t.dtype) for t in _tensors(fake_out)]
    assert got == [(tuple(t.shape), t.dtype) for t in _tensors(real_out)]


def test_seams_under_autograd_count_forward_and_backward():
    """attention, the router, WKV-6 and the selective scan differentiated
    on the CPU: each family's forward and backward seam once, none of the
    plain versions' products (the counted FLOPs are the seams')."""
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.kernels.mamba_scan import ops as MS
    from repro_torch.kernels.moe_router import route_tokens
    from repro_torch.kernels.rwkv6_scan import ops as RS
    from repro_torch.roofline.op_analysis import analyze_ops

    make = _maker()
    q, k, v = (make((1, 8, 2, 32), torch.float32).requires_grad_()
               for _ in range(3))
    x = make((24, 16), torch.float32).requires_grad_()
    w = make((16, 4), torch.float32).requires_grad_()
    r, kk, vv = (make((1, 5, 1, 16), torch.float32).requires_grad_()
                 for _ in range(3))
    wd = make((1, 5, 1, 16), torch.float32, "decay")
    u = make((1, 16), torch.float32).requires_grad_()
    xc, b, c = (make(s, torch.float32).requires_grad_()
                for s in ((1, 6, 4), (1, 6, 16), (1, 6, 16)))
    dt = make((1, 6, 4), torch.float32, "pos")
    a = make((4, 16), torch.float32, "neg")

    def step():
        outs = [attention(q, k, v).sum(),
                route_tokens(x, w, top_k=2, group_size=8)[0].sum(),
                RS.wkv(r, kk, vv, wd, u)[0].sum(),
                MS.scan(xc, dt, b, c, a)[0].sum()]
        return torch.autograd.grad(sum(outs), (q, k, v, x, w, r, kk, vv, u,
                                               xc, b, c))

    got = analyze_ops(step)
    assert {n: k["launches"] for n, k in got["kernels"].items()} == {
        n: 1 for n in ("flash_attention", "flash_attention_bwd",
                       "moe_router", "moe_router_bwd", "rwkv6_scan",
                       "rwkv6_scan_bwd", "mamba_scan", "mamba_scan_bwd")}
    assert got["flops"] == sum(k["flops"] for k in got["kernels"].values())


def test_kernel_bounds_reproduce_the_kernel_table():
    """PERF.md's kernel table (bounds in µs, MB, GFLOP, to the digits it
    prints) at its shapes: prox_update (CNN LAN, per config, cohort,
    phi3's w_gate), attention (deepseek prefill and decode, Whisper,
    Qwen2-VL, Jamba, phi3's training forward), the fused router, WKV-6,
    the attention, router and WKV backwards, the selective scan, and
    tier_update (phi3's w_gate and its whole tree)."""
    from repro_torch.roofline import kernels as W

    def us(w):
        return round(w.bound_s * 1e6, 1)

    def mb(w, d=1):
        return round(w.bytes / 1e6, d)

    att = dict(q_itemsize=2, kv_itemsize=2)
    prox = W.prox_update(40, 206_922, itemsize=4, anchor_rows=4)
    assert (mb(prox), us(prox), prox.bound_by) == (102.6, 30.6, "bytes")
    cfg = W.prox_update(120, 206_922, itemsize=4, anchor_rows=12, groups=3)
    assert (mb(cfg), us(cfg)) == (307.9, 91.9)
    cohort = W.prox_update(512, 610, itemsize=4, anchor_rows=2)
    assert (mb(cohort), us(cohort)) == (3.8, 1.1)
    gate = W.prox_update(1, 805_306_368, itemsize=2, anchor_rows=1)
    assert (mb(gate), us(gate)) == (6442.5, 1923.1)
    tier = W.tier_update(805_306_368, 2)
    assert (mb(tier), us(tier), tier.bound_by) == (8053.1, 2403.9, "bytes")
    tree = W.tier_update(3_821_079_552, 2)
    assert (round(tree.bound_ms, 2), tree.bound_by) == (11.41, "bytes")

    pre = W.attention(4, 1024, 1024, 16, 16, 128, causal=True, window=0,
                      q_offset=0, **att)
    assert (mb(pre), round(pre.flops / 1e9, 1), us(pre)) == (67.1, 17.2,
                                                            20.0)
    dec = W.attention(4, 1, 1040, 16, 16, 128, causal=True, window=0,
                      q_offset=1030, **att)
    assert (mb(dec), us(dec)) == (33.8, 10.1)
    enc = W.attention(4, 1500, 1500, 12, 12, 64, causal=False, window=0,
                      q_offset=0, **att)
    assert (mb(enc), round(enc.flops / 1e9, 2), us(enc), enc.bound_by) == \
        (36.9, 27.65, 28.0, "operations")
    cross = W.attention(4, 1, 1500, 12, 12, 64, causal=False, window=0,
                        q_offset=0, **att)
    assert (mb(cross), us(cross)) == (18.4, 5.5)
    vlm = W.attention(4, 1024, 1024, 12, 2, 128, causal=True, window=0,
                      q_offset=0, **att)
    assert (mb(vlm), round(vlm.flops / 1e9, 2), us(vlm)) == (29.4, 12.90,
                                                            13.0)
    jam = W.attention(4, 1024, 1024, 64, 8, 128, causal=True, window=0,
                      q_offset=0, **att)
    assert (mb(jam), round(jam.flops / 1e9, 2), us(jam)) == (151.0, 68.79,
                                                            69.6)
    jdec = W.attention(4, 1, 1040, 64, 8, 128, causal=True, window=0,
                       q_offset=1030, **att)
    assert (mb(jdec), us(jdec)) == (17.0, 5.1)
    phi = W.attention(4, 1024, 1024, 32, 32, 96, causal=True, window=0,
                      q_offset=0, **att)
    assert (mb(phi), round(phi.flops / 1e9, 2), us(phi)) == (100.7, 25.79,
                                                            30.0)

    router = W.moe_router(4096, 2048, 64, 6, x_itemsize=2)
    assert (mb(router, 2), round(router.bound_s * 1e6, 2),
            round(router.ops_s * 1e6, 2), round(router.at("f32") * 1e6, 2)
            ) == (17.60, 5.25, 4.34, 16.03)
    rdec = W.moe_router(4, 2048, 64, 6, x_itemsize=2)
    assert (mb(rdec, 2), round(rdec.bound_s * 1e6, 2)) == (0.54, 0.16)
    jr = W.moe_router(4096, 8192, 16, 2, x_itemsize=2)
    assert (mb(jr, 2), round(jr.bound_s * 1e6, 2)) == (67.73, 20.22)
    jrd = W.moe_router(4, 8192, 16, 2, x_itemsize=2)
    assert (mb(jrd, 2), round(jrd.bound_s * 1e6, 2)) == (0.59, 0.18)

    wkv = W.rwkv6_scan(4, 1024, 64, 64, itemsize=2, state=True)
    assert (mb(wkv), us(wkv), round(wkv.at("f32") * 1e6, 1)) == \
        (209.7, 62.6, 80.1)
    wdec = W.rwkv6_scan(4, 1, 64, 64, itemsize=2, state=True)
    assert (mb(wdec), us(wdec)) == (8.6, 2.6)

    bwd = [W.attention_bwd(*shape, causal=True, window=win, q_offset=off,
                           q_itemsize=s, kv_itemsize=s)
           for shape, win, off, s in (
               ((4, 1024, 1024, 32, 32, 96), 0, 0, 2),
               ((4, 1024, 1024, 16, 16, 128), 0, 0, 2),
               ((2, 512, 768, 12, 2, 128), 256, 256, 2),
               ((2, 512, 768, 12, 2, 128), 256, 256, 4))]
    assert [(mb(w), round(w.flops / 1e9, 2), us(w)) for w in bwd] == [
        (201.9, 64.49, 65.2), (134.5, 42.99, 43.5), (15.8, 4.03, 4.7),
        (31.5, 4.03, 60.1)]
    nc = W.attention_bwd(4, 1500, 1500, 12, 12, 64, causal=False, window=0,
                         q_offset=0, q_itemsize=2, kv_itemsize=2)
    assert (mb(nc), round(nc.flops / 1e9, 2), us(nc)) == (74.0, 69.12, 69.9)

    rb = W.moe_router_bwd(4096, 2048, 64, 6)
    assert (mb(rb, 2), round(rb.bound_s * 1e6, 2),
            round(rb.flops / 1e9, 2)) == (35.95, 10.73, 6.44)
    jrb = W.moe_router_bwd(4096, 8192, 16, 2)
    assert (mb(jrb, 2), round(jrb.bound_s * 1e6, 2)) == (135.63, 40.49)
    lb = W.route_topk_bwd(4096, 64, 6)
    assert (mb(lb, 2), round(lb.bound_s * 1e6, 2)) == (2.39, 0.71)

    wb = W.rwkv6_scan_bwd(4, 1024, 64, 64, itemsize=2, state=False)
    assert (mb(wb), us(wb), round(wb.flops / 1e9, 1),
            round(wb.at("f32") * 1e6, 1)) == (377.5, 112.7, 15.0, 224.4)

    scan = W.mamba_scan(4, 1024, 16384, 16, itemsize=2, backward=False,
                        state=False)
    assert (us(scan), scan.bound_by, round(scan.exponentials / 1e9, 2),
            mb(scan)) == (256.8, "operations", 1.07, 408.2)
    sb = W.mamba_scan(4, 1024, 16384, 16, itemsize=2, backward=True,
                      state=False)
    assert (us(sb), mb(sb)) == (256.8, 677.9)
