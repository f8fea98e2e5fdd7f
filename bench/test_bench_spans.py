"""Device time by span (``bench/spans.py``) on hand-made traces:
operations under the innermost span open at their launch (autograd's
thread included), an operation with no launch and one launched outside
every span, coverage, the idle gaps by the span the host was in, kernel
families; the span tracer's log over its window alone, moved onto the
trace's clock, off when asked, and closed where the path raises; a
small cell's traced tier rounds on the CPU; and, on the card, a 2-layer
cut of phi3-mini-3.8b at its published widths attributed whole."""
import pytest

from bench import core, spans
from bench.conftest import small_cell
from bench.trace import TraceData


def _round(t0):
    """One tier round's spans from ``t0`` (microseconds): a local step of
    forward (embed, blocks, head), backward and prox step, then the two
    updates."""
    r, ls = "tier_round", "tier_round/local_step"
    return [(r, t0, t0 + 100, {}), (ls, t0 + 1, t0 + 80, {}),
            (f"{ls}/forward", t0 + 2, t0 + 30, {}),
            (f"{ls}/forward/embed", t0 + 2, t0 + 5, {}),
            (f"{ls}/forward/blocks", t0 + 5, t0 + 25, {}),
            (f"{ls}/forward/head", t0 + 25, t0 + 30, {}),
            (f"{ls}/backward", t0 + 30, t0 + 70, {}),
            (f"{ls}/prox_step", t0 + 70, t0 + 80, {}),
            (f"{r}/team_update", t0 + 80, t0 + 90, {}),
            (f"{r}/server_update", t0 + 90, t0 + 99, {})]


def _synthetic():
    """Kernels launched in embed, blocks, head, backward (launched from
    autograd's thread while the caller waits: only its time says where),
    prox step and both updates; a copy with no launch event; a kernel
    launched after the round; gaps on the device inside the backward.
    Returns the window and its :class:`TraceData`."""
    ops = [("embed_kernel", 10, 4, 1), ("gemm_fwd", 14, 20, 2),
           ("loss_kernel", 40, 6, 3), ("gemm_bwd", 60, 40, 4),
           ("prox_kernel<bf16>", 110, 10, 5), ("team_kernel", 121, 8, 6),
           ("server_kernel", 130, 6, 7), ("Memcpy DtoD", 137, 3, 99),
           ("late_kernel", 150, 5, 8)]
    launched = {1: 3, 2: 6, 3: 26, 4: 45, 5: 71, 6: 81, 7: 91, 8: 120}
    t = TraceData(cell=None, window_s=400e-6, steps=1,
                  device=[(s, s + d) for _, s, d, _ in ops])
    return spans.Window(ops, launched, _round(0)), t


def test_operations_go_to_the_innermost_span_open_at_their_launch():
    w, _ = _synthetic()
    got = {op[0]: sp and sp[0].rsplit("/", 1)[-1]
           for op, sp in spans.attribute(w)}
    assert got == {"embed_kernel": "embed", "gemm_fwd": "blocks",
                   "loss_kernel": "head", "gemm_bwd": "backward",
                   "prox_kernel<bf16>": "prox_step",
                   "team_kernel": "team_update",
                   "server_kernel": "server_update", "Memcpy DtoD": None,
                   "late_kernel": None}


def test_device_time_and_coverage_by_span():
    w, _ = _synthetic()
    assert spans.device_seconds(w, "forward") == pytest.approx(30e-6)
    assert spans.device_seconds(w, "backward") == pytest.approx(40e-6)
    assert spans.device_seconds(w, "team_update", "server_update") == \
        pytest.approx(14e-6)
    assert spans.device_seconds(w, "local_step") == pytest.approx(80e-6)
    assert spans.coverage(w) == pytest.approx(100 * 94 / 102)
    assert spans.coverage(spans.Window([], {}, _round(0))) is None
    assert [sp[0] for sp in spans.rounds(w)] == ["tier_round"]
    at = spans.span_at(_round(0))
    assert at(-1) is None and at(100) is None
    assert at(95)[0] == "tier_round/server_update"
    assert at(99.5)[0] == "tier_round"


def test_idle_gaps_go_to_the_span_the_host_was_in():
    w, t = _synthetic()
    idle = spans.idle_by_span(t, w)
    # the device idles 34..40 and 46..60 while the host is inside the
    # backward; its later gaps (100..110, 120..121, 129..130, 136..137,
    # 140..150) begin after the host left the round
    assert idle == {"tier_round/local_step/backward": pytest.approx(20e-6),
                    None: pytest.approx(23e-6)}
    assert spans.idle_by_span(t, spans.Window(w.ops, w.launched, [])) == \
        {None: pytest.approx(43e-6)}


@pytest.mark.parametrize("name,want", [
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("void attn_wgmma<96, true>(Params)", "attention"),
    ("void (anonymous namespace)::dkv_kernel<96>(CUtensorMap_st)",
     "attention"),
    ("void prox_kernel<__nv_bfloat16>(Args)", "prox"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda", "copy"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<8, CUDAFunctor_add>",
     "elementwise"),
    ("void cunn_SoftMaxForward<8, float>", "other")])
def test_kernel_families(name, want):
    assert spans.family(name) == want


def test_read_moves_spans_onto_the_trace_clock():
    from repro_torch.obs.spans import SpanLog

    log = SpanLog()
    with log.activate(), log.span("tier_round"):
        pass
    base = log.epoch_ns - 7_000_000                  # 7 ms earlier
    w = spans.read({"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 7000.5, "dur": 2.0,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 7000.25, "dur": 1.0, "args": {"correlation": 5}},
        {"ph": "i", "cat": "cuda_runtime", "name": "mark", "ts": 1.0,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 7003.0,
         "dur": 1.0, "args": {}}]}, log)
    (sp,) = log.spans
    assert w.spans == [("tier_round", 7000 + sp.t0 * 1e6,
                        7000 + (sp.t0 + sp.dur) * 1e6, {})]
    assert w.ops == [("k", 7000.5, 2.0, 5), ("Memcpy", 7003.0, 1.0, None)]
    assert w.launched == {5: 7000.25}
    assert spans.read({"traceEvents": []}) == spans.Window()


@pytest.mark.parametrize("log", [True, False])
def test_tracer_records_spans_over_the_window_alone(tmp_path, log):
    from repro_torch.obs.spans import current_log, span

    with spans.SpanTracer(None, tmp_path, log=log) as tracer:
        tracer.plain()
        with span("tier_round", k=1):
            pass
        tracer.start()
        assert (current_log() is not None) == log
        with span("tier_round", k=2):
            with span("local_step"):
                pass
        tracer.stop()
    assert current_log() is None
    got = tracer.window.spans
    if not log:
        assert got == [] and tracer.log is None
    else:
        assert [(p, a) for p, _, _, a in got] == [
            ("tier_round", {"k": 2}), ("tier_round/local_step", {})]
        assert all(s <= e for _, s, e, _ in got)
    assert tracer.data.window_s > 0
    assert set(tracer.host) == set(spans.HOST)
    assert tracer.host["cpu_s"] >= 0 and tracer.host["gc_full"] >= 0
    assert list(tmp_path.iterdir()) == []


def test_tracer_closes_its_log_where_the_path_raises(tmp_path):
    from repro_torch.obs.spans import current_log, span

    with pytest.raises(RuntimeError):
        with spans.SpanTracer(None, tmp_path) as tracer:
            tracer.plain()
            tracer.start()
            with span("tier_round"):
                raise RuntimeError("the path failed inside the window")
    assert current_log() is None and tracer._prof is None
    assert [sp.name for sp in tracer.log.spans] == ["tier_round"]


def test_a_small_cells_traced_rounds_record_their_spans(tmp_path):
    cell = small_cell("phi3-mini-3.8b", "tier_b4_s1024", 3000000041)
    path = core.load("paths", "lm_tier").Path(cell)
    path.setup()
    with spans.SpanTracer(cell, tmp_path) as tracer:
        attempted, failed = path.traced(tracer)
    k = cell.mix["trace_rounds"]
    assert (attempted, failed) == (2 * k, 0)
    assert len(spans.rounds(tracer.window)) == tracer.data.steps == k
    names = [p.rsplit("/", 1)[-1] for p, _, _, _ in tracer.window.spans]
    l_local = cell.mix["tier"]["l_local"]
    assert names.count("prox_step") == names.count("backward") == k * l_local
    assert names.count("team_update") == names.count("server_update") == k


@pytest.mark.gpu
def test_a_traced_tier_round_is_attributed_to_its_spans(cuda, tmp_path):
    """At least 99% of the device time under a span; every prox kernel
    inside a ``prox_step`` span, as many as the program launched; no
    product in the team and server updates."""
    cell = small_cell("phi3-mini-3.8b", "tier_b4_s1024", 3000000041,
                      device="cuda", full=True)
    cell.config["model"]["num_layers"] = 2
    path = core.load("paths", "lm_tier").Path(cell)
    path.setup()
    with spans.SpanTracer(cell, tmp_path) as tracer:
        path.traced(tracer)
    w = tracer.window
    owned = spans.attribute(w)
    assert spans.coverage(w) >= 99.0
    prox = [sp and sp[0] for op, sp in owned if "prox_kernel<" in op[0]]
    assert prox and tracer.data.launches["prox_update"] == len(prox)
    assert set(prox) == {"tier_round/local_step/prox_step"}
    products = [op[0] for op, sp in owned
                if sp and spans.under(sp[0], ("team_update", "server_update"))
                and spans.family(op[0]) == "gemm"]
    assert products == []
    assert len(spans.rounds(w)) == tracer.data.steps == \
        cell.mix["trace_rounds"]
    assert spans.device_seconds(w, "forward") > 0
    assert spans.device_seconds(w, "backward") > 0
