"""Which WKV-6 kernel variant ``rwkv6_scan.plan`` picks, and the chunked
kernel's math in plain PyTorch (``ref.wkv6_chunked``) on the CPU.

``plan`` is a pure function of types and shapes, so it is asked here with
tensors on the meta device at the served shapes. ``wkv6_chunked`` is held
in float32 to the port's ``wkv6_ref`` and to the JAX package's
``repro.kernels.rwkv6_scan.ref.wkv6_ref`` on numpy inputs from a seed,
under three kinds of decay (the model's, w = exp(-exp(-6 + LoRA)); the
chip check's, x ~ N(-3, 1); strong ones, x ~ N(0, 2), with entries of w
exactly 0 and exactly 1), chunk-ragged lengths, and a given state or
none: within 1e-5 of the output's and of the state's scale, as
``chip_smoke.py::wkv_errors`` holds the kernel (the sums run in another
order). With ``split_tf32=True`` (the kernel's 3xTF32 operand splits) and
bf16 r/k/v it is held to ``wkv6_ref`` within that same unchanged
tolerance: a bf16 output within 2^-7 of each value plus 1e-5 of the
scale, the float32 state within 1e-5 of its scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.kernels.rwkv6_scan.ref import wkv6_ref as j_wkv6_ref  # noqa: E402

BF16 = torch.bfloat16


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _plan_args(b, t, h, n, rkv=BF16, w=torch.float32):
    return [_meta((b, t, h, n), rkv) for _ in range(3)] + [
        _meta((b, t, h, n), w), _meta((b, h, n, n), torch.float32)]


PLAN_CASES = [
    ("rwkv6-7b prefill", _plan_args(4, 1024, 64, 64), "chunked"),
    ("rwkv6-7b decode", _plan_args(4, 1, 64, 64), "simt"),
    ("t 15", _plan_args(2, 15, 4, 64), "simt"),
    ("t 16", _plan_args(2, 16, 4, 64), "chunked"),
    ("t 17", _plan_args(2, 17, 4, 64), "chunked"),
    ("bf16 w", _plan_args(2, 130, 4, 64, w=BF16), "chunked"),
    ("f32 r/k/v", _plan_args(4, 1024, 64, 64, rkv=torch.float32), "simt"),
    ("n 16", _plan_args(2, 130, 3, 16), "simt"),
    ("n 32", _plan_args(2, 130, 3, 32), "simt"),
    ("f32 r/k/v, bf16 w", _plan_args(2, 130, 4, 64, rkv=torch.float32,
                                      w=BF16), "simt"),
]


@pytest.mark.parametrize("args,want", [c[1:] for c in PLAN_CASES],
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_picks_the_variant(args, want):
    from repro_torch.kernels.rwkv6_scan import plan

    assert plan(*args) == want
    assert plan(*args[:4], None) == want       # the state never decides


def test_plan_mixed_types_and_variant_counts():
    """bf16 r and k with a float32 v is not the chunked kernel's; the
    variant counters start at 0 and reset to 0."""
    from repro_torch.kernels.rwkv6_scan import VARIANTS, plan, reset_variants

    r, k, _, w, s = _plan_args(2, 64, 4, 64)
    assert plan(r, k, _meta(r.shape, torch.float32), w, s) == "simt"
    assert set(VARIANTS) == {"chunked", "simt"}
    VARIANTS["simt"] += 3
    reset_variants()
    assert VARIANTS == {"chunked": 0, "simt": 0}


def _decays(rng, kind, shape):
    """w in [0, 1] as float32: the model's (exp(-exp(-6 + LoRA)), the
    LoRA a tanh-bounded term of size up to 0.5), the chip check's
    (x ~ N(-3, 1)) or strong ones (x ~ N(0, 2)) with runs of w exactly 0
    and exactly 1."""
    if kind == "model":
        x = -6.0 + 0.5 * np.tanh(rng.standard_normal(shape))
    elif kind == "chip":
        x = rng.standard_normal(shape) - 3.0
    else:
        x = 2.0 * rng.standard_normal(shape)
    w = np.exp(-np.exp(x))
    if kind == "strong":
        w[..., ::7] = 0.0
        w[:, 3::5, :, 1::6] = 1.0
        w[:, 10:20] = 1.0
    return w.astype(np.float32)


def _inputs(b, t, h, n, kind, state, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    w = _decays(rng, kind, (b, t, h, n))
    u = 0.1 * rng.standard_normal((h, n)).astype(np.float32)
    s = rng.standard_normal((b, h, n, n)).astype(np.float32) if state \
        else None
    return r, k, v, w, u, s


def _within(got, want, rel):
    """out within rel of each value + 1e-5 of the scale, the state within
    1e-5 of its scale (chip_smoke.py::wkv_errors)."""
    (o, s), (o_p, s_p) = ([np.asarray(x, np.float32) for x in pair]
                          for pair in (got, want))
    assert np.all(np.abs(o - o_p) <= rel * np.abs(o_p)
                  + 1e-5 * np.abs(o_p).max()), np.abs(o - o_p).max()
    assert np.abs(s - s_p).max() <= 1e-5 * np.abs(s_p).max(), \
        np.abs(s - s_p).max()


@pytest.mark.parametrize("state", [True, False], ids=["state", "zeros"])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 33, 130])
@pytest.mark.parametrize("kind", ["model", "chip", "strong"])
def test_wkv6_chunked_matches_sequential(kind, t, state):
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked, wkv6_ref

    arrays = _inputs(2, t, 2, 64, kind, state, seed=t + 7 * len(kind))
    port = [None if a is None else torch.from_numpy(a) for a in arrays]
    got = wkv6_chunked(*port)
    assert got[0].shape == (2, t, 2, 64) and got[0].dtype == torch.float32
    assert got[1].shape == (2, 2, 64, 64) and got[1].dtype == torch.float32
    assert all(bool(torch.isfinite(x).all()) for x in got)
    got = tuple(x.numpy() for x in got)
    _within(got, tuple(x.numpy() for x in wkv6_ref(*port)), 0.0)
    j_out = j_wkv6_ref(*(None if a is None else jnp.asarray(a)
                         for a in arrays))
    _within(got, tuple(np.asarray(x) for x in j_out), 0.0)


@pytest.mark.parametrize("state", [True, False], ids=["state", "zeros"])
@pytest.mark.parametrize("kind", ["model", "chip", "strong"])
def test_wkv6_chunked_split_tf32_bf16(kind, state):
    """The kernel's precision plan at (2, 130, 4, 64) with bf16 r/k/v and
    a float32 w: 3xTF32 / 2xTF32 products within the chip check's
    unchanged tolerance of the sequential f32 scan."""
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked, wkv6_ref

    r, k, v, w, u, s = _inputs(2, 130, 4, 64, kind, state, seed=len(kind))
    rkv = [torch.from_numpy(x).to(BF16) for x in (r, k, v)]
    rest = [torch.from_numpy(w), torch.from_numpy(u),
            None if s is None else torch.from_numpy(s)]
    got = wkv6_chunked(*rkv, *rest, split_tf32=True)
    want = wkv6_ref(*rkv, *rest)
    assert got[0].dtype == BF16
    _within((got[0].float().numpy(), got[1].numpy()),
            (want[0].float().numpy(), want[1].numpy()), 2.0 ** -7)


def test_tf32_rounds_to_nearest_ties_away():
    """The TF32 rounding the split emulates: 10 mantissa bits, ties away
    from zero (cvt.rna), exact for bf16 values; hi + lo recovers x to
    ~2^-22 of it."""
    from repro_torch.kernels.rwkv6_scan.ref import _split, _tf32

    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 0.0, 3.0e-3])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 0.0])
    assert torch.equal(_tf32(x)[:5], want)
    b = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    b = b.to(BF16).float()
    assert torch.equal(_tf32(b), b)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    hi, lo = _split(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


# --- the backward's variants --------------------------------------------

@pytest.mark.parametrize("args,want", [c[1:] for c in PLAN_CASES],
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_bwd_picks_the_variant(args, want):
    """plan_bwd takes the forward's rule (chunked: bf16 r, k, v, f32 or
    bf16 w, head size 64, t >= 16), a pure function of types and shapes:
    meta tensors, with the state or without, and contiguous or not."""
    from repro_torch.kernels.rwkv6_scan import plan_bwd

    assert plan_bwd(*args) == want
    assert plan_bwd(*args[:4], None) == want
    strided = [torch.empty(x.shape[:3] + (2 * x.shape[3],), dtype=x.dtype,
                           device="meta")[..., ::2] for x in args[:4]]
    assert not strided[0].is_contiguous()
    assert plan_bwd(*strided) == want


def test_bwd_variant_counts_and_scratch():
    """The backward's variant counters start at 0 and reset with the
    forward's; the snapshot scratch is a state every 64 steps (chunked)
    or every 8 (simt)."""
    from repro_torch.kernels.rwkv6_scan import BWD_VARIANTS, reset_variants
    from repro_torch.kernels.rwkv6_scan.ops import BWD_CHUNK, BWD_SEGMENT, \
        bwd_scratch

    assert set(BWD_VARIANTS) == {"chunked", "simt"}
    BWD_VARIANTS["chunked"] += 2
    reset_variants()
    assert BWD_VARIANTS == {"chunked": 0, "simt": 0}
    assert (BWD_SEGMENT, BWD_CHUNK) == (64, 8)
    r = _meta((4, 1024, 64, 64), BF16)
    assert bwd_scratch(r, "chunked").shape == (4 * 64 * 16 * 64 * 64,)
    assert bwd_scratch(r, "simt").shape == (4 * 64 * 128 * 64 * 64,)
    r = _meta((2, 1000, 3, 64), BF16)     # a ragged last segment
    assert bwd_scratch(r, "chunked").shape == (2 * 3 * 16 * 64 * 64,)
    assert bwd_scratch(r, "chunked").dtype == torch.float32


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,n,variant,want", [
    ("bfloat16", 64, None, "chunked"),
    ("bfloat16", 64, "simt", "simt"),
    ("float32", 64, None, "simt"),
    ("bfloat16", 32, None, "simt")])
def test_bwd_wrapper_calls_its_kernel_and_raises_on_failure(
        monkeypatch, dtype, n, variant, want):
    """With the kernel path forced on CPU tensors and each library's entry
    point stubbed, wkv_bwd calls the variant plan_bwd picks (or the one
    named) with as many arguments as its C signature has, counts one
    launch and the variant, and raises on the kernel's error code; the
    other variant is never run (no fallback). A chunked launch on tensors
    it does not take raises before anything runs."""
    from repro_torch.kernels.interface import LAUNCHES, KernelType
    from repro_torch.kernels.rwkv6_scan import BWD_VARIANTS, ops, wkv_bwd

    calls = {}

    def stub(name, n_args):
        def fn(*args):
            calls[name] = args
            assert len(args) == n_args
            return 700                  # cudaErrorIllegalAddress
        return lambda: fn

    def fail():
        raise AssertionError("the other variant ran")

    monkeypatch.setattr(ops, "kernel_mode", lambda t, mode: KernelType.CUDA)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(ops, "_bwd_chunked_fn", stub("chunked", 20)
                        if want == "chunked" else fail)
    monkeypatch.setattr(ops, "_bwd_fn", stub("simt", 22)
                        if want == "simt" else fail)
    r, k, v, w, u, s = _inputs(2, 40, 3, n, "model", True, seed=n)
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(dt) for x in (r, k, v)] + [
        torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(s),
        torch.zeros(2, 40, 3, n, dtype=dt), torch.zeros(2, 3, n, n)]
    launches = LAUNCHES.get("rwkv6_scan_bwd", 0)
    counted = BWD_VARIANTS[want]
    with pytest.raises(RuntimeError, match=f"rwkv6_scan_bwd {want} kernel "
                                           "launch failed: CUDA error 700"):
        wkv_bwd(*args, variant=variant)
    assert LAUNCHES["rwkv6_scan_bwd"] == launches + 1
    assert BWD_VARIANTS[want] == counted + 1
    got = calls[want]
    if want == "chunked":
        assert got[0] == 0 and got[16:19] == (2, 40, 3)    # f32 w; b, t, h
    else:
        assert got[:3] == (1 if dtype == "bfloat16" else 0, 0, n)
        assert got[18:21] == (2, 40, 3)
    if want == "simt" and n == 64 and dtype == "float32":
        with pytest.raises(ValueError, match="chunked kernel takes bfloat16"):
            wkv_bwd(*args, variant="chunked")
        assert LAUNCHES["rwkv6_scan_bwd"] == launches + 1
