"""The port's spans (``repro_torch.obs.spans``) in the LM trainer, on the
CPU: a tier round's spans and their parents, the trajectory bit-equal
with a log and without, spans on the clock of ``torch.profiler``'s
exported trace, the collector's null path and export, and the tiered
example's ``--trace-dir`` read back by ``python -m repro_torch.obs
report``.

A reduced phi3-mini-3.8b (2 layers, d 256, vocab 256), float32, batches
of 2 x 16 tokens.
"""
import contextlib
import io
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.obs.spans import SpanLog, current_log, span  # noqa: E402

B, S, VOCAB = 2, 16, 256
TIER = dict(alpha=3e-3, lam=0.5, gamma=1.5, eta=0.03, beta=0.3)


def _model():
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M

    cfg = get_reduced_config("phi3-mini-3.8b").replace(vocab_size=VOCAB)
    return cfg, M.init_params(0, cfg, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, VOCAB, (B, S + 1)))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _leaves(tree):
    from repro_torch.flat import tree_leaves
    return [p for _, p in tree_leaves(tree)]


def _forward(parent):
    return [("forward", parent), ("embed", "forward"), ("blocks", "forward"),
            ("head", "forward"), ("backward", parent)]


@pytest.mark.parametrize("l_local", [1, 2, 3])
def test_tier_round_spans_nest_as_the_round_runs(l_local):
    from repro_torch.train.trainer import make_tier_round

    cfg, params = _model()
    round_fn = make_tier_round(cfg, l_local=l_local, **TIER)
    log = SpanLog()
    with log.activate():
        for _ in range(2):
            round_fn(params, params, params, _batch())
    want = [("tier_round", None)]
    for _ in range(l_local):
        want += [("local_step", "tier_round")] + _forward("local_step") \
            + [("prox_step", "local_step")]
    want += [("team_update", "tier_round"), ("server_update", "tier_round")]
    got = [(sp.name, sp.parent and sp.parent.name) for sp in log.spans]
    assert got == want * 2
    assert all(sp.attrs == {} for sp in log.spans)
    assert all(sp.dur is not None and sp.dur >= 0 for sp in log.spans)
    back = next(sp for sp in log.spans if sp.name == "backward")
    assert back.path == "tier_round/local_step/backward"


def test_tier_round_is_bit_identical_under_a_log():
    from repro_torch.train.trainer import make_tier_round

    cfg, params = _model()
    batch = _batch(1)
    plain = make_tier_round(cfg, l_local=2, **TIER)(params, params, params,
                                                    batch)
    with SpanLog().activate():
        traced = make_tier_round(cfg, l_local=2, **TIER)(params, params,
                                                         params, batch)
    for a, b in zip(plain[:3], traced[:3]):
        assert all(torch.equal(x, y)
                   for x, y in zip(_leaves(a), _leaves(b)))
    assert torch.equal(plain[3]["loss"], traced[3]["loss"])


@pytest.mark.parametrize("kind", ["train_step", "device_step"])
def test_other_trainers_record_the_inner_spans(kind):
    from repro_torch.train import optim
    from repro_torch.train.train_state import TrainState
    from repro_torch.train.trainer import (make_permfl_device_step,
                                           make_train_step)

    cfg, params = _model()
    log = SpanLog()
    with log.activate():
        if kind == "train_step":
            opt = optim.sgd()
            make_train_step(cfg, opt, lr=1e-2)(
                TrainState.create(params, opt), _batch())
            want = _forward(None)
        else:
            make_permfl_device_step(cfg, alpha=1e-2, lam=0.5)(
                params, params, _batch())
            want = _forward(None) + [("prox_step", None)]
    assert [(sp.name, sp.parent and sp.parent.name)
            for sp in log.spans] == want


def test_record_function_inside_a_span_lies_inside_it_on_the_trace_clock(
        tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    log = SpanLog()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with log.activate(), span("outer"):
            time.sleep(2e-3)
            with record_function("probe"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(2e-3)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    (probe,) = [e for e in trace["traceEvents"]
                if e.get("name") == "probe" and e.get("ph") == "X"]
    lo = trace["baseTimeNanoseconds"] + probe["ts"] * 1e3
    hi = lo + probe["dur"] * 1e3
    ours = log.to_chrome()
    (outer,) = ours["traceEvents"]
    start = ours["baseTimeNanoseconds"] + outer["ts"] * 1e3
    end = start + outer["dur"] * 1e3
    assert start + 1e6 < lo < hi < end - 1e6       # a millisecond inside
    assert end - start < 50e6


def test_span_without_a_log_is_one_shared_context():
    assert current_log() is None
    first, second = span("a", x=1), span("b")
    assert first is second
    with first as sp:
        assert sp.set(y=2) is sp


def test_a_span_closes_when_its_body_raises():
    log = SpanLog()
    with log.activate():
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("stop")
        with span("after"):
            pass
    assert [(sp.name, sp.depth, sp.dur is not None) for sp in log.spans] \
        == [("outer", 0, True), ("inner", 1, True), ("after", 0, True)]
    assert log.spans[2].parent is None


def test_export_names_parents_and_its_clock(tmp_path):
    from repro_torch.obs.report import load_artifacts

    before = time.time_ns()
    log = SpanLog(meta={"who": "test"})
    with log.activate():
        with span("a"):
            with span("b", k=3):
                with span("c"):
                    pass
    saved = json.loads(log.save(tmp_path, "clock").read_text())
    assert before <= saved["baseTimeNanoseconds"] <= time.time_ns()
    assert "time_ns" in saved["otherData"]["clock"]
    assert saved["metadata"] == {"who": "test"}
    assert [e["args"] for e in saved["traceEvents"]] == [
        {}, {"k": 3, "parent": "a"}, {"parent": "a/b"}]
    assert load_artifacts(tmp_path)["spans"] == [saved]


def test_example_saves_spans_and_report_prints_their_totals(tmp_path):
    import importlib.util
    import pathlib

    from repro_torch.obs.__main__ import main as obs_main

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "tiered_example", root / "examples" / "tiered_llm_training_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io.StringIO()):
        example.main(["--device", "cpu", "--rounds", "2", "--teams", "2",
                      "--seq-len", "16", "--trace-dir", str(tmp_path)])
    assert current_log() is None
    (saved,) = tmp_path.glob("spans-tiered-*.trace.json")
    names = [e["name"] for e in json.loads(saved.read_text())["traceEvents"]]
    assert names.count("tier_round") == 4 and names.count("local_step") == 8
    assert names.count("team_update") == names.count("server_update") == 4
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert obs_main(["report", str(tmp_path)]) == 0
    lines = {line.split()[0]: line.split()[1] for line in
             out.getvalue().splitlines() if line.startswith("  ")
             and len(line.split()) > 1}
    assert lines["tier_round"] == "x4" and lines["prox_step"] == "x8"
    assert lines["backward"] == "x8" and lines["server_update"] == "x4"
