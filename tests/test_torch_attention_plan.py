"""The attention op's dispatch and the split-kv decode's math, on the CPU.

``plan`` picks the kernel variant (``wgmma`` / ``split_kv`` / ``simt``)
from types, shapes, strides and addresses alone, so it is held here
without a card for the served models' shapes (phi3-mini's head_dim 96
on the Hopper variants too); ``plan_bwd`` picks the backward's
(``wgmma`` / ``simt``) for the trained models' shapes, and the forward's
and the backward's wrappers hand their kernels as many arguments as the
C signatures in the sources have and raise, never fall back, when the
kernel fails. ``attention_partials`` + ``combine_partials`` are the split-kv kernel's math in plain PyTorch
(chunks of the visible keys, each chunk's (m, l, acc), the merge); in
float32 they must equal ``attention_ref`` within 1e-6 (one softmax over the
row against chunked ones: float32 rounding). The JAX package's
``attention_ref`` holds the same numbers for the decode rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_VARIANTS, VARIANTS, attention, attention_bwd, attention_lse_ref,
    attention_partials, attention_ref, combine_partials, plan, plan_bwd,
    visible_keys)

BF16, F32 = torch.bfloat16, torch.float32


def _t(shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def _cache(b, n, hkv, d, dtype=BF16):
    """k, v as the engine hands them over: slices of a stacked cache."""
    stack = torch.zeros(2, 3, b, n, hkv, d, dtype=dtype)
    return stack[0, 1], stack[1, 1]


# (label, q shape, kv shape, q dtype, kv dtype, q_offset, window, expected)
PLAN_CASES = [
    ("deepseek prefill", (4, 1024, 16, 128), (4, 1024, 16, 128), BF16, BF16,
     0, 0, ("wgmma", 1)),
    ("deepseek decode", (4, 1, 16, 128), (4, 1040, 16, 128), BF16, BF16,
     1030, 0, ("split_kv", 9)),
    ("qwen3 40:8 prefill", (1, 96, 40, 128), (1, 96, 8, 128), BF16, BF16,
     0, 0, ("wgmma", 1)),
    ("qwen3 40:8 decode", (1, 1, 40, 128), (1, 1040, 8, 128), BF16, BF16,
     1039, 0, ("split_kv", 16)),
    ("qwen2-vl 12:2 decode", (2, 1, 12, 128), (2, 1040, 2, 128), BF16, BF16,
     700, 0, ("split_kv", 10)),
    ("qwen2-vl 12:2 prefill", (2, 300, 12, 128), (2, 300, 2, 128), BF16,
     BF16, 0, 0, ("wgmma", 1)),
    ("whisper head_dim 64 prefill", (2, 256, 12, 64), (2, 256, 12, 64), BF16,
     BF16, 0, 0, ("wgmma", 1)),
    ("decode at q_offset 0", (4, 1, 16, 128), (4, 1040, 16, 128), BF16,
     BF16, 0, 0, ("split_kv", 1)),
    ("windowed decode", (1, 1, 4, 128), (1, 1040, 4, 128), BF16, BF16, 1000,
     256, ("split_kv", 4)),
    ("f32 prefill", (4, 1024, 16, 128), (4, 1024, 16, 128), F32, F32, 0, 0,
     ("simt", 1)),
    ("f32 decode", (4, 1, 16, 128), (4, 1040, 16, 128), F32, F32, 1030, 0,
     ("simt", 1)),
    ("bf16 q, f32 cache", (4, 1, 16, 128), (4, 1040, 16, 128), BF16, F32,
     1030, 0, ("simt", 1)),
    ("head_dim 96", (2, 256, 8, 96), (2, 256, 8, 96), BF16, BF16, 0, 0,
     ("wgmma", 1)),
    # phi3-mini (32 heads of 96): its training forward, its decode on a
    # 1,040-slot cache (128 (b, h) blocks: 5 chunks fill 4 waves of 132
    # SMs), and in f32
    ("phi3 train forward", (4, 1024, 32, 96), (4, 1024, 32, 96), BF16, BF16,
     0, 0, ("wgmma", 1)),
    ("phi3 decode", (4, 1, 32, 96), (4, 1040, 32, 96), BF16, BF16, 1030, 0,
     ("split_kv", 5)),
    ("f32 head_dim 96", (4, 1024, 32, 96), (4, 1024, 32, 96), F32, F32, 0, 0,
     ("simt", 1)),
    ("f32 head_dim 96 decode", (4, 1, 32, 96), (4, 1040, 32, 96), F32, F32,
     1030, 0, ("simt", 1)),
    ("head_dim 32 decode", (2, 1, 4, 32), (2, 96, 2, 32), BF16, BF16, 50, 0,
     ("simt", 1)),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_plan_picks_variant(case):
    _, qs, kvs, qdt, kvdt, q_offset, window, want = case
    k, v = _cache(kvs[0], kvs[1], kvs[2], kvs[3], kvdt)
    assert plan(_t(qs, qdt), k, v, causal=True, window=window,
                q_offset=q_offset) == want


# Whisper-small and Qwen2-VL-2B served at full width (chip_smoke.py): (label,
# q shape, kv shape, causal, q_offset, expected). The encoder's and the
# prefill cross-attention's k/v are fresh projections; the decode steps
# read slices of the stacked cache (:func:`test_serving_cache_slices_plan`).
SERVE_CASES = [
    ("whisper encoder", (4, 1500, 12, 64), (4, 1500, 12, 64), False, 0,
     ("wgmma", 1)),
    ("whisper cross prefill", (4, 64, 12, 64), (4, 1500, 12, 64), False, 0,
     ("wgmma", 1)),
    ("whisper self prefill", (4, 64, 12, 64), (4, 64, 12, 64), True, 0,
     ("wgmma", 1)),
    ("qwen2-vl 12:2 prefill", (4, 1024, 12, 128), (4, 1024, 2, 128), True,
     0, ("wgmma", 1)),
    ("jamba 64:8 prefill", (4, 1024, 64, 128), (4, 1024, 8, 128), True, 0,
     ("wgmma", 1)),
]


@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: c[0])
def test_plan_serving_prefill_shapes(case):
    _, qs, kvs, causal, q_offset, want = case
    assert plan(_t(qs), _t(kvs), _t(kvs), causal=causal,
                q_offset=q_offset) == want


@pytest.mark.parametrize("arch,max_len,cross,q_offset,want", [
    ("whisper-small", 80, True, 0, ("split_kv", 11)),
    ("whisper-small", 80, True, 78, ("split_kv", 11)),
    ("whisper-small", 80, False, 64, ("split_kv", 1)),
    ("whisper-small", 80, False, 78, ("split_kv", 1)),
    ("qwen2-vl-2b", 1040, False, 1024, ("split_kv", 16)),
    ("qwen2-vl-2b", 1040, False, 1038, ("split_kv", 16)),
    ("jamba-1.5-large-398b", 1040, False, 1030, ("split_kv", 16)),
    ("phi3-mini-3.8b", 1040, False, 1024, ("split_kv", 5)),
    ("phi3-mini-3.8b", 1040, False, 1039, ("split_kv", 5)),
])
def test_serving_cache_slices_plan(arch, max_len, cross, q_offset, want):
    """Every block's slice of the full-width stacked bf16 cache (the meta
    device: shapes, strides and offsets only) keeps 16-byte aligned rows,
    so a decode step's attention is split_kv, never simt: Whisper's cross
    K/V over its 1,500 frames (non-causal, q_offset 0: 11 chunks at b = 4,
    12 kv-heads) and its self K/V, Qwen2-VL's 12:2 cache, Jamba's 64:8
    cache (the attention position of each hybrid block), phi3-mini's 32
    heads of 96 (rows of 192 bytes). A float32 cache under a bf16 q takes
    simt."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import _aligned
    from repro_torch.models import transformer

    cfg = get_config(arch)
    q = torch.empty(4, 1, cfg.num_heads, cfg.resolved_head_dim, dtype=BF16,
                    device="meta")
    k_name, v_name = ("cross_k", "cross_v") if cross else ("k", "v")
    causal = not cross
    n_blocks, pattern = transformer.block_pattern(cfg)
    attn = f"pos{[kind for kind, _ in pattern].index('attn')}"
    for dt, expect in ((BF16, want), (F32, ("simt", 1))):
        cache = transformer.stack_cache(cfg, 4, max_len, dt, device="meta")
        for i in range(n_blocks):
            blk = cache[attn]
            k, v = blk[k_name][i], blk[v_name][i]
            assert k.shape == (4, cfg.encoder_seq_len if cross else max_len,
                               cfg.num_kv_heads, cfg.resolved_head_dim)
            assert _aligned(k) and _aligned(v)
            assert plan(q, k, v, causal=causal, q_offset=q_offset) == expect


def test_plan_deepseek_decode_chunks():
    """deepseek's decode (64 (b, h) pairs, 1,031 visible keys) gets 8-16
    chunks of 64-128 rows: a grid of several waves on 132 SMs."""
    k, v = _cache(4, 1040, 16, 128)
    _, splits = plan(_t((4, 1, 16, 128)), k, v, q_offset=1030)
    _, n = visible_keys(1040, q_offset=1030)
    assert 8 <= splits <= 16 and 64 <= -(-n // splits) <= 128
    assert splits * 4 * 16 >= 4 * 132


def test_plan_unaligned_views_take_simt():
    """Rows that do not start on 16 bytes (heads sliced at an odd column,
    an odd offset) cannot be read by TMA or 16-byte loads: simt."""
    kv = torch.zeros(2, 50, 5, 136, dtype=BF16)
    k, v = kv[:, :, 1:3, 1:129], kv[:, :, 3:5, :128]
    q = torch.zeros(2, 40, 4, 128, dtype=BF16)
    assert plan(q, k, v) == ("simt", 1)
    assert plan(q[:, :1], k, v) == ("simt", 1)
    k2, v2 = kv[:, :, 1:3, 8:136], kv[:, :, 3:5, :128]    # 16-byte offset
    assert plan(q, k2, v2) == ("wgmma", 1)
    wide = torch.zeros(2, 40, 4, 129, dtype=BF16)[..., :128]  # odd stride
    assert plan(wide, k2, v2) == ("simt", 1)
    # head_dim 96: 96 columns of a row of 104 (208 bytes) keep the Hopper
    # variants; one column in, or a row of 100 (200 bytes), do not
    kv96 = torch.zeros(2, 50, 4, 104, dtype=BF16)
    q96 = torch.zeros(2, 40, 4, 96, dtype=BF16)
    k96, v96 = kv96[:, :, :2, :96], kv96[:, :, 2:, 8:]
    assert plan(q96, k96, v96) == ("wgmma", 1)
    assert plan(q96[:, :1], k96, v96, q_offset=45)[0] == "split_kv"
    assert plan(q96, kv96[:, :, :2, 1:97], v96) == ("simt", 1)
    odd = torch.zeros(2, 50, 4, 100, dtype=BF16)[..., :96]
    assert plan(q96, odd[:, :, :2], odd[:, :, 2:]) == ("simt", 1)


def test_plan_ignores_strides_of_length_one_axes():
    """A batch of one or a single head never follows its stride."""
    k, v = _cache(1, 1040, 16, 128)
    q = torch.zeros(16 * 128, dtype=BF16).as_strided((1, 1, 16, 128),
                                                     (5, 3, 128, 1))
    assert plan(q, k, v, q_offset=500)[0] == "split_kv"
    q3 = torch.zeros(3 * 16 * 128, dtype=BF16).as_strided((1, 3, 16, 128),
                                                          (5, 3, 128, 1))
    assert plan(q3, k, v, q_offset=500)[0] == "simt"


def test_cpu_attention_counts_no_variant():
    """On the CPU the plain version runs: no kernel variant is counted."""
    before = dict(VARIANTS)
    q = torch.randn(1, 1, 4, 64).to(BF16)
    k = torch.randn(1, 40, 4, 64).to(BF16)
    attention(q, k, k, q_offset=30)
    assert VARIANTS == before


# (b, skv, hq, hkv, d, causal, window, q_offset, splits)
PARTIAL_CASES = [
    (2, 1040, 16, 16, 128, True, 0, 1030, 9),      # deepseek decode
    (2, 1040, 16, 16, 128, True, 0, 1039, 9),      # the cache's last slot
    (2, 96, 8, 2, 64, True, 0, 0, 4),               # q_offset 0: one key
    (1, 300, 40, 8, 128, True, 64, 250, 7),         # window starts mid-chunk
    (1, 300, 12, 2, 64, True, 100, 299, 3),
    (2, 200, 4, 4, 64, False, 0, 50, 64),           # empty chunks
    (2, 1040, 32, 32, 96, True, 0, 1030, 5),        # phi3 decode, head_dim 96
    (1, 300, 8, 2, 96, True, 100, 299, 3),          # head_dim 96, GQA, window
    (1, 50, 4, 1, 32, True, 30, 10, 5),
    (1, 40, 4, 2, 64, True, 0, -1, 2),              # nothing seen at all
]


@pytest.mark.parametrize("case", PARTIAL_CASES, ids=lambda c: "x".join(
    map(str, c[:5])) + ("c" if c[5] else "n") + f"w{c[6]}o{c[7]}s{c[8]}")
def test_split_partials_combine_to_attention_ref(case):
    b, skv, hq, hkv, d, causal, window, q_offset, splits = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, 1, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    m, l, acc = attention_partials(q, k, v, splits=splits, **kw)
    assert m.shape == l.shape == (b, hq, splits)
    assert acc.shape == (b, hq, splits, d)
    lo, n = visible_keys(skv, **kw)
    chunk = -(-n // splits) if n else 1
    empty = [i for i in range(splits) if lo + i * chunk >= lo + n]
    for i in empty:    # a chunk with nothing to see does not poison the merge
        assert bool((m[:, :, i] == -1e30).all() and (l[:, :, i] == 0).all())
    got = combine_partials(m, l, acc)
    want = attention_ref(q, k, v, **kw)
    assert got.shape == want.shape == (b, 1, hq, d)
    assert float((got - want).abs().max()) <= 1e-6
    if q_offset >= 0:
        jax_want = np.asarray(jax_attention_ref(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
            window=window, q_offset=q_offset))
        np.testing.assert_allclose(got.numpy(), jax_want, atol=2e-5)


def test_split_partials_take_one_row_only():
    q = torch.zeros(1, 2, 4, 64)
    k = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="one query row"):
        attention_partials(q, k, k, q_offset=7)


# The backward's variant (label, q shape, kv shape, q dtype, kv dtype,
# expected), asked with meta-device tensors: the tensor-core backward for
# bf16 at head_dim 64, 96 and 128, the CUDA-core one for the rest.
BWD_PLAN_CASES = [
    ("phi3 train", (4, 1024, 32, 96), (4, 1024, 32, 96), BF16, BF16,
     "wgmma"),
    ("deepseek train", (4, 1024, 16, 128), (4, 1024, 16, 128), BF16, BF16,
     "wgmma"),
    ("qwen2-vl 12:2 train", (4, 1024, 12, 128), (4, 1024, 2, 128), BF16,
     BF16, "wgmma"),
    ("head_dim 64 non-causal", (4, 1500, 12, 64), (4, 1500, 12, 64), BF16,
     BF16, "wgmma"),
    ("one query row", (2, 1, 4, 96), (2, 77, 2, 96), BF16, BF16, "wgmma"),
    ("f32 phi3", (4, 1024, 32, 96), (4, 1024, 32, 96), F32, F32, "simt"),
    ("f32 GQA 12:2", (2, 512, 12, 128), (2, 768, 2, 128), F32, F32, "simt"),
    ("head_dim 32", (2, 100, 4, 32), (2, 100, 2, 32), BF16, BF16, "simt"),
    ("bf16 q, f32 cache", (2, 64, 16, 128), (2, 1040, 16, 128), BF16, F32,
     "simt"),
]


@pytest.mark.parametrize("case", BWD_PLAN_CASES, ids=lambda c: c[0])
def test_plan_bwd_picks_variant(case):
    _, qs, kvs, qdt, kvdt, want = case
    q, out, dout = (torch.empty(qs, dtype=qdt, device="meta")
                    for _ in range(3))
    k, v = (torch.empty(kvs, dtype=kvdt, device="meta") for _ in range(2))
    assert plan_bwd(q, k, v) == plan_bwd(q, k, v, out, dout) == want


def test_plan_bwd_unaligned_views_take_simt():
    """A stacked-cache view whose rows do not start on 16 bytes (heads
    sliced at an odd column), an odd row stride or a misaligned dout take
    the CUDA-core backward; a 16-byte offset keeps the tensor-core one."""
    kv = torch.zeros(2, 50, 5, 136, dtype=BF16)
    q = torch.zeros(2, 40, 4, 128, dtype=BF16)
    k, v = kv[:, :, 1:3, 1:129], kv[:, :, 3:5, :128]
    assert plan_bwd(q, k, v) == "simt"
    k2 = kv[:, :, 1:3, 8:136]                       # 16-byte offset
    assert plan_bwd(q, k2, v) == "wgmma"
    wide = torch.zeros(2, 40, 4, 129, dtype=BF16)[..., :128]  # odd stride
    assert plan_bwd(wide, k2, v) == "simt"
    assert plan_bwd(q, k2, v, q, wide) == "simt"    # dout
    assert plan_bwd(q, k2, v, q, q.transpose(1, 2).contiguous()
                    .transpose(1, 2)) == "wgmma"    # strided but aligned


def test_cpu_attention_bwd_counts_no_variant():
    """On the CPU the plain backward runs: no backward variant is
    counted."""
    before = dict(BWD_VARIANTS)
    q, do = (torch.randn(1, 8, 4, 64).to(BF16) for _ in range(2))
    k = torch.randn(1, 8, 4, 64).to(BF16)
    out, lse = attention_lse_ref(q, k, k)
    attention_bwd(q, k, k, out, lse, do)
    assert BWD_VARIANTS == before


class _Stream:
    cuda_stream = 0


def _stub(calls, name, n_args):
    """A loader of an entry point that records its arguments under
    ``name``, checks their count and fails as a kernel does (error 700,
    cudaErrorIllegalAddress)."""
    def fn(*args):
        calls[name] = args
        assert len(args) == n_args
        return 700
    return lambda: fn


def _fail():
    raise AssertionError("another variant ran")


def _bwd_inputs(d, dtype=BF16):
    rng = np.random.default_rng(d)
    q, do = (torch.from_numpy(rng.standard_normal((2, 200, 4, d))
                              .astype(np.float32)).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 150, 2, d))
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    out, lse = attention_lse_ref(q, k, v, q_offset=0)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("d,variant", [(96, "wgmma"), (32, "simt")])
def test_bwd_wrapper_calls_its_kernel_and_raises_on_failure(monkeypatch, d,
                                                            variant):
    """With the kernel path forced on CPU tensors and each library's entry
    point stubbed, attention_bwd calls the variant plan_bwd picks with as
    many arguments as its C signature has (the wgmma one with sq padded
    to 128 rows of lse2 / delta scratch), counts one launch and the
    variant, and raises on the kernel's error code; the other variant is
    never run (no fallback). A build that fails raises too."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.interface import LAUNCHES, KernelType

    calls = {}
    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    wgmma = _stub(calls, "wgmma", _c_arity("flash_attention_bwd_hopper.cu",
                                           "flash_attention_bwd_wgmma"))
    simt = _stub(calls, "simt", _c_arity("flash_attention_bwd.cu",
                                         "flash_attention_bwd"))
    monkeypatch.setattr(ops, "_bwd_wgmma_fn",
                        wgmma if variant == "wgmma" else _fail)
    monkeypatch.setattr(ops, "_bwd_fn", simt if variant == "simt" else _fail)
    q, k, v, out, lse, do = _bwd_inputs(d)
    assert plan_bwd(q, k, v, out, do) == variant
    launches = LAUNCHES.get("flash_attention_bwd", 0)
    counted = BWD_VARIANTS[variant]
    with pytest.raises(RuntimeError,
                       match=f"flash_attention_bwd {variant} kernel launch "
                             "failed: error 700"):
        attention_bwd(q, k, v, out, lse, do, q_offset=0)
    assert LAUNCHES["flash_attention_bwd"] == launches + 1
    assert BWD_VARIANTS[variant] == counted + 1
    args = calls[variant]
    if variant == "wgmma":
        assert args[0] == d and args[12:18] == (2, 200, 150, 4, 2, 256)
    else:
        assert args[:3] == (1, 1, d) and args[13:18] == (2, 200, 150, 4, 2)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ops, "_bwd_wgmma_fn" if variant == "wgmma"
                        else "_bwd_fn", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        attention_bwd(q, k, v, out, lse, do, q_offset=0)


def _c_arity(source, name):
    """The number of parameters of ``extern "C" int name(...)`` in the
    kernel source ``csrc/<source>``."""
    import re
    from pathlib import Path

    from repro_torch.kernels.flash_attention import ops

    text = (Path(ops.__file__).parent / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, name
    return m.group(1).count(",") + 1


# (label, q shape, kv shape, q_offset, variant, its entry point: (source,
# C name, ops' loader))
FWD_WRAPPER_CASES = [
    ("96 prefill", (2, 200, 4, 96), (2, 150, 2, 96), 0, "wgmma",
     ("flash_attention_hopper.cu", "flash_attention_wgmma", "_wgmma_fn")),
    ("96 decode", (2, 1, 4, 96), (2, 150, 2, 96), 140, "split_kv",
     ("flash_attention_hopper.cu", "flash_attention_split_kv",
      "_split_fn")),
    ("32", (2, 200, 4, 32), (2, 150, 2, 32), 0, "simt",
     ("flash_attention.cu", "flash_attention", "_simt_fn")),
]


@pytest.mark.parametrize("case", FWD_WRAPPER_CASES, ids=lambda c: c[0])
def test_fwd_wrapper_calls_its_kernel_and_raises_on_failure(monkeypatch,
                                                            case):
    """The forward's counterpart of the backward's wrapper test: with the
    kernel path forced on CPU tensors and each entry point stubbed,
    attention calls the variant plan picks (head_dim 96 prefill on wgmma,
    its decode on split_kv, head_dim 32 on simt) with as many arguments as
    its C signature has, counts one launch and the variant, and raises on
    the kernel's error code; no other variant runs (no fallback). A build
    that fails raises too."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.interface import LAUNCHES, KernelType

    _, qs, kvs, q_offset, variant, (source, c_name, loader) = case
    calls = {}
    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    for other in ("_wgmma_fn", "_split_fn", "_simt_fn"):
        monkeypatch.setattr(ops, other, _fail)
    monkeypatch.setattr(ops, loader,
                        _stub(calls, variant, _c_arity(source, c_name)))
    rng = np.random.default_rng(len(qs) + qs[1])
    q = torch.from_numpy(rng.standard_normal(qs).astype(np.float32)).to(BF16)
    k, v = (torch.from_numpy(rng.standard_normal(kvs).astype(np.float32))
            .to(BF16) for _ in range(2))
    assert plan(q, k, v, q_offset=q_offset)[0] == variant
    launches = LAUNCHES.get("flash_attention", 0)
    counted = dict(VARIANTS)
    with pytest.raises(RuntimeError,
                       match=f"flash_attention {variant} kernel launch "
                             "failed: error 700"):
        attention(q, k, v, q_offset=q_offset)
    assert LAUNCHES["flash_attention"] == launches + 1
    counted[variant] += 1
    assert VARIANTS == counted
    args = calls[variant]
    b, sq, hq, d = qs
    skv, hkv = kvs[1], kvs[2]
    if variant == "wgmma":
        assert args[0] == d and args[5:10] == (b, sq, skv, hq, hkv)
        assert args[22:25] == (q_offset, 1, 0) and args[26] is None
    elif variant == "split_kv":
        splits = plan(q, k, v, q_offset=q_offset)[1]
        lo, n = visible_keys(skv, q_offset=q_offset)
        assert args[0] == d and args[9:12] == (b, hq, hkv)
        assert args[22:26] == (lo, n, -(-n // splits), splits)
    else:
        assert args[:3] == (1, 1, d) and args[7:12] == (b, sq, skv, hq, hkv)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ops, loader, no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        attention(q, k, v, q_offset=q_offset)
