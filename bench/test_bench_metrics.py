"""The metric arithmetic on hand-made traces: the idle union with
overlapping kernels, roofline shares and their launch cross-check, both
MFU formulas, the breakdown's labels."""
import pytest

from bench import trace
from bench.trace import TraceData


class _Cell:
    def __init__(self, config, mix):
        self.config, self.mix = config, mix


CNN = {"model": {"input_shape": [28, 28, 1], "conv_channels": [16, 32],
                 "hidden": [128], "num_classes": 10},
       "federation": {"m_teams": 4, "n_devices": 10, "train_per_device": 36,
                      "val_per_device": 12},
       "algorithm": {"k_team": 5, "l_local": 10}, "parameters": 206922,
       "tf32": False}
PHI3 = {"model": {"num_layers": 32, "d_model": 3072, "num_heads": 32,
                  "num_kv_heads": 32, "head_dim": 96, "d_ff": 8192,
                  "vocab_size": 32064}, "precision": "bfloat16"}


def _trace(kernels, window_s=100e-6, **kw):
    t = TraceData(cell=kw.pop("cell", None), window_s=window_s, **kw)
    for name, s, d in kernels:
        t.kernels.append((name, s, d))
        t.device.append((s, s + d))
    return t


def test_overlapping_kernels_count_once():
    t = _trace([("a", 10, 20), ("b", 20, 20), ("c", 70, 10)],
               plain_s=80e-6)
    assert trace.union(t.device) == [(10, 40), (70, 80)]
    assert t.busy_s == pytest.approx(40e-6)
    assert trace.idle_share(t) == pytest.approx(50.0)
    assert trace.gaps(t) == [(40, 70)]


def test_roofline_share_and_its_launch_check():
    t = _trace([("void prox_kernel<float>(Args<float>)", 0, 40),
                ("void prox_kernel<float>(Args<float>)", 50, 40),
                ("other", 95, 5)], launches={"prox_update": 2})
    assert trace.roofline_share(t, 60e-6, ("prox_kernel<",), "prox_update",
                                2) == pytest.approx(75.0)
    assert trace.roofline_share(t, 60e-6, ("prox_kernel<",), "prox_update",
                                3) is None
    assert trace.roofline_share(t, 60e-6, ("absent",), "prox_update",
                                2) is None


def test_cnn_flops_from_its_shapes():
    from bench.yardstick.flops import cnn_forward_flops, permfl_round_flops
    fwd, first = cnn_forward_flops(CNN["model"])
    assert first == 2 * 28 * 28 * 9 * 1 * 16
    assert fwd == first + 2 * 14 * 14 * 9 * 16 * 32 + 2 * 1568 * 128 \
        + 2 * 128 * 10
    assert permfl_round_flops(CNN) == 50 * 40 * 36 * (3 * fwd - first) \
        + 40 * (3 * 12 + 36) * fwd


def test_fl_round_mfu_reads_the_window():
    from bench.core import load
    t = _trace([], window_s=0.9, plain_s=0.5, cell=_Cell(CNN, {}), steps=2)
    from bench.yardstick.flops import permfl_round_flops
    want = 100 * 2 * permfl_round_flops(CNN) / 0.5 / 67e12
    assert load("metrics", "fl_round_mfu").read(t) == pytest.approx(want)


def test_lm_flops_count_products_and_causal_attention():
    from bench.yardstick.flops import lm_matmul_params, lm_pass_flops
    n = lm_matmul_params(PHI3["model"])
    assert n == 32 * (4 * 3072 ** 2 + 3 * 3072 * 8192) + 3072 * 32064
    pairs = 1024 * 1025 // 2
    assert lm_pass_flops(PHI3["model"], 4, 1024) == pytest.approx(
        6 * n * 4096 + 12 * 4 * 32 * 96 * pairs * 32)


def test_lm_step_mfu_and_attention_rooflines():
    from bench.core import load
    from bench.yardstick.flops import lm_pass_flops
    from bench.yardstick.work import attention
    mix = {"batch": 4, "seq_len": 1024, "tier": {"l_local": 2}}
    k = [("void attn_wgmma_kernel<96>(CUtensorMap)", 10.0 * i, 100.0)
         for i in range(128)]
    t = _trace(k, window_s=2.0, plain_s=1.5, cell=_Cell(PHI3, mix), steps=2,
               launches={"flash_attention": 128})
    want = 100 * 2 * 2 * lm_pass_flops(PHI3["model"], 4, 1024) / 1.5 / 989e12
    assert load("metrics", "lm_step_mfu").read(t) == pytest.approx(want)
    w = attention(4, 1024, 1024, 32, 32, 96, causal=True, q_itemsize=2,
                  kv_itemsize=2, lse=True)
    assert load("metrics", "attn_fwd_roofline.lm").read(t) == \
        pytest.approx(100 * w.bound_s / 100e-6)


def test_breakdown_labels_gaps_by_what_they_waited_for():
    t = _trace([("k1", 5, 10), ("k1", 30, 10), ("k2", 60, 30)],
               window_s=100e-6)
    b = trace.breakdown(t)
    assert b["device_ops"] == [["k2", pytest.approx(30e-6)],
                               ["k1", pytest.approx(20e-6)]]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle.pop("before k1") == pytest.approx(15e-6)
    assert idle.pop("before k2") == pytest.approx(20e-6)
    assert list(idle.values()) == [pytest.approx(15e-6)]


def test_ef_topk_roofline_counts_both_uplinks():
    from bench.core import load
    from bench.yardstick.work import ef_topk
    mix = {"uplink": {"compressor": "topk"}}
    k = [("void count_kernel<false, true>(float const*)", 0, 30),
         ("void scan_kernel<false, true>(float const*)", 40, 60)] * 6
    t = _trace(k, cell=_Cell(CNN, mix), steps=1, launches={"ef_topk": 6})
    cols = 206976                       # 206,922 padded to 64
    want = 5 * ef_topk(40, cols, 206922, 8).bound_s \
        + ef_topk(4, cols, 206922, 8).bound_s
    assert load("metrics", "ef_topk_roofline.fl").read(t) == \
        pytest.approx(100 * want / (6 * 90e-6))
    assert load("metrics", "ef_topk_roofline.fl").read(
        _trace(k, cell=_Cell(CNN, {"uplink": None}), steps=1)) is None
