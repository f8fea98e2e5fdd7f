"""The port's run telemetry (``repro_torch.obs``) against the JAX
package's (``repro.obs``).

- Probe and health series of traced runs, fed the reference's params and
  masks (and cohort maps): PerMFL on the MCLR and the CNN (one round,
  rtol 1e-5 / atol 1e-6) and the MCLR over 3 rounds (the rounds'
  tolerance, rtol 1e-4 / atol 1e-4), a compressed top-k run (the EF
  residual probes), baselines (the update norm and the nonfinite
  counts), a cohort run (probes at cohort width) and a sweep; detector
  counts exactly.
- Trace on leaves the trajectory bit-identical; ``round`` leaves its
  input state's tensors bit-unchanged (PerMFL and every baseline), which
  the update-norm and update detectors rely on.
- Fail-fast at ``eta=1e30``: the same round in both packages, and
  ``config 1`` in a two-config sweep.
- The JSONL event log equal to the reference's (apart from run ids,
  timings and cost), each package's ``summarize`` / ``report`` reading
  the other's trace dir, the Prometheus text byte-equal, spans.
- The CLI's ``run --trace-dir / --fail-fast / --profile-dir`` and
  ``serve --trace-dir`` on ``--smoke --device cpu``.

Sizes: ``small_fed_data`` (4 teams x 3 devices) with K = L = 2, and the
quad fixture of ``tests/test_torch_cohort.py`` (3 x 6 devices, 5
parameters).
"""
import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.comm import CommConfig as JCommConfig  # noqa: E402
from repro.configs.paper_cnn import CONFIG as J_CNN  # noqa: E402
from repro.configs.paper_mclr import CONFIG as J_MCLR  # noqa: E402
from repro.core import PerMFL as JPerMFL  # noqa: E402
from repro.core import PerMFLHParams as JHParams  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core.participation import sample_masks as j_sample_masks  # noqa: E402,E501
from repro.models import paper_models as JPM  # noqa: E402
from repro.obs import TraceConfig as JTraceConfig  # noqa: E402
from repro.obs.health import HealthError as JHealthError  # noqa: E402
from repro.train.engine import run_experiment as j_run  # noqa: E402
from repro.train.sweep import run_sweep as j_sweep  # noqa: E402

# probes of one round, and the rounds' tolerance (ROADMAP.md queue 3)
TOL_1 = dict(rtol=1e-5, atol=1e-6)
TOL_3 = dict(rtol=1e-4, atol=1e-4)
HP = dict(k_team=2, l_local=2)
FRAC = dict(team_frac=0.5, device_frac=0.67)

# the quad problem of tests/test_torch_cohort.py
M, N, D = 3, 6, 5
COHORT = 4
QHP = dict(alpha=0.05, eta=0.04, beta=0.3, lam=0.8, gamma=2.0, k_team=3,
           l_local=4)
P0 = {"p": np.zeros(D, np.float32)}


def j_quad(params, batch):
    return 0.5 * jnp.sum((params["p"] - batch["c"]) ** 2)


def j_neg(params, batch):
    return -j_quad(params, batch)


def quad(params, batch):
    """The port's quad loss: per-device (D,) from leaves (D, ...)."""
    return 0.5 * ((params["p"] - batch["c"]) ** 2).sum(-1)


def neg(params, batch):
    return -quad(params, batch)


@pytest.fixture(scope="module")
def quad_data():
    rng = np.random.default_rng(0)
    return {"c": rng.normal(size=(M, N, D)).astype(np.float32)}


def port_algo(name, **hp):
    from repro_torch.comm import CommConfig
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.core import baselines as B

    return {
        "permfl": lambda: PerMFL(quad, PerMFLHParams(**dict(QHP, **hp))),
        "permfl_topk": lambda: PerMFL(quad, PerMFLHParams(**QHP),
                                      comm=CommConfig("topk", k_frac=0.4)),
        "permfl_randk": lambda: PerMFL(quad, PerMFLHParams(**QHP),
                                       comm=CommConfig("randk", k_frac=0.4)),
        "fedavg": lambda: B.FedAvg(quad, lr=0.1, local_steps=3),
        "perfedavg": lambda: B.PerFedAvg(quad, lr=0.05, inner_lr=0.04,
                                         local_steps=2),
        "pfedme": lambda: B.PFedMe(quad, lr=1.0, inner_lr=0.03, lam=15.0,
                                   inner_steps=2, local_rounds=2),
        "ditto": lambda: B.Ditto(quad, lr=0.05, lam=0.5, local_steps=3),
        "hsgd": lambda: B.HSGD(quad, lr=0.05, k_team=2, l_local=2),
        "l2gd": lambda: B.L2GD(quad, lr=0.05, lam_c=0.5, lam_g=0.5,
                               k_team=2, l_local=2),
    }[name]()


def jax_algo(name, **hp):
    return {
        "permfl": lambda: JPerMFL(j_quad, JHParams(**dict(QHP, **hp))),
        "permfl_topk": lambda: JPerMFL(j_quad, JHParams(**QHP),
                                       comm=JCommConfig("topk", k_frac=0.4)),
        "fedavg": lambda: JB.FedAvg(j_quad, lr=0.1, local_steps=3),
        "ditto": lambda: JB.Ditto(j_quad, lr=0.05, lam=0.5, local_steps=3),
    }[name]()


def jax_masks(seed, rounds, m, width, team_frac, device_frac):
    """The reference engine's masks: its carried key split once a round."""
    key, chain = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        chain.append(tuple(np.asarray(a) for a in j_sample_masks(
            sub, m, width, team_frac=team_frac, device_frac=device_frac)))
    return chain.__getitem__


def run_quad(name, data, **kw):
    from repro_torch.train.engine import run_experiment
    kw = dict(dict(metric_fn=neg, m=M, n=N, device="cpu"), **kw)
    return run_experiment(port_algo(name), P0, data, data, **kw)


def j_run_quad(name, data, **kw):
    d = jax.tree.map(jnp.asarray, data)
    return j_run(jax_algo(name), jax.tree.map(jnp.asarray, P0), d, d,
                 metric_fn=j_neg, m=M, n=N, **kw)


def assert_series_close(got, want, tol):
    """Two {name: per-round list} streams: the same names and lengths,
    values within ``tol``."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def assert_traces_match(res, jres, tol):
    """Probe series within ``tol``, detector series exactly."""
    assert_series_close(res.trace.series, jres.trace.series, tol)
    assert res.health.series == {k: [float(x) for x in v]
                                 for k, v in jres.health.series.items()}


# ------------------------------------------------ PerMFL on the paper models

def _paper_fns(kind):
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    from repro_torch.scenarios.spec import fns_for

    jcfg = {"mclr": J_MCLR, "cnn": J_CNN}[kind]
    jfns = (lambda p, b: JPM.loss_fn(p, jcfg, b),
            lambda p, b: JPM.accuracy(p, jcfg, b))
    return jfns, fns_for({"mclr": MCLR, "cnn": CNN}[kind]), jcfg


def _paper_runs(fd, kind, rounds, **kw):
    """The reference's and the port's traced PerMFL runs of one paper
    model on ``fd`` from the reference's params, with the reference's
    sampled masks; ``kw`` goes to both engines (``trace_dir`` as a pair
    (reference's, port's))."""
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.obs import TraceConfig
    from repro_torch.train.engine import run_experiment

    (jl, jm), (pl, pmf), jcfg = _paper_fns(kind)
    m, n = fd.m_teams, fd.n_devices
    train = {"x": fd.train_x, "y": fd.train_y}
    val = {"x": fd.val_x, "y": fd.val_y}
    p0 = JPM.init_params(jax.random.PRNGKey(3), jcfg)
    jdir, pdir = kw.pop("trace_dir", (None, None))
    scan = kw.pop("scan", True)
    jres = j_run(JPerMFL(jl, JHParams(**HP)), p0,
                 jax.tree.map(jnp.asarray, train),
                 jax.tree.map(jnp.asarray, val), metric_fn=jm,
                 rounds=rounds, m=m, n=n, seed=5, scan=scan,
                 trace=JTraceConfig(), trace_dir=jdir, **FRAC, **kw)
    res = run_experiment(PerMFL(pl, PerMFLHParams(**HP)),
                         jax.tree.map(np.asarray, p0), train, val,
                         metric_fn=pmf, rounds=rounds, m=m, n=n, seed=5,
                         masks=jax_masks(5, rounds, m, n, **FRAC),
                         trace=TraceConfig(), trace_dir=pdir, device="cpu",
                         **FRAC, **kw)
    assert res.participation == jres.participation
    return res, jres


@pytest.mark.parametrize("kind", ["mclr", "cnn"])
def test_one_round_probes_and_health_match_the_reference(small_fed_data,
                                                         kind):
    res, jres = _paper_runs(small_fed_data, kind, 1)
    assert res.trace.names() == ["grad_norm", "part_loss", "pers_gap_max",
                                 "pers_gap_mean", "tier_drift_max",
                                 "tier_drift_mean", "update_norm"]
    assert res.health.names() == ["loss_exploded", "nonfinite_params",
                                  "nonfinite_update"]
    assert_traces_match(res, jres, TOL_1)


@pytest.fixture(scope="module")
def mclr_traced(small_fed_data, tmp_path_factory):
    """3 traced MCLR rounds, eval every 2, in both packages, each writing
    its trace dir: (port result, reference result, port dir, reference
    dir)."""
    pdir = tmp_path_factory.mktemp("port_trace")
    jdir = tmp_path_factory.mktemp("jax_trace")
    # scan=False: the reference's per-round dispatch path, whose
    # dispatch count (rounds + evals) the port's loop reports
    res, jres = _paper_runs(small_fed_data, "mclr", 3, eval_every=2,
                            scan=False, trace_dir=(str(jdir), str(pdir)))
    return res, jres, pdir, jdir


def test_three_rounds_probes_and_health_match_the_reference(mclr_traced):
    res, jres, _, _ = mclr_traced
    assert len(res.trace) == len(res.health) == 3
    assert_traces_match(res, jres, TOL_3)
    assert res.health.ok() and jres.health.ok()
    assert res.dispatches == jres.dispatches == 5       # 3 rounds + 2 evals


def _drop(obj, keys):
    """``obj`` without ``keys`` at any depth."""
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def _assert_close_tree(got, want, path=""):
    """JSON values: equal structure, strings, ints, bools and None
    equal, floats within the rounds' tolerance."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)), path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            np.testing.assert_allclose(got, want, err_msg=path, **TOL_3)
    else:
        assert got == want and type(got) is type(want), path


def test_run_events_equal_the_reference(mclr_traced):
    """The same run's JSONL events in both packages: equal apart from the
    run ids, the timings and the cost."""
    from repro.obs.events import read_jsonl as j_read
    from repro_torch.obs.events import read_jsonl

    _, _, pdir, jdir = mclr_traced
    skip = {"run", "seconds", "compile_seconds", "run_seconds", "cost"}
    got, want = _drop(read_jsonl(pdir), skip), _drop(j_read(jdir), skip)
    assert [e["event"] for e in got] == ["run_header", "eval", "eval",
                                         "run_footer"]
    assert [e["round"] for e in got[1:3]] == [2, 3]
    assert set(got[1]["probes"]) == set(want[1]["probes"])
    _assert_close_tree(got, want)


def test_each_package_reads_the_others_trace_dir(mclr_traced):
    from repro.obs import report as JREP
    from repro.obs.__main__ import main as j_obs_main
    from repro_torch.obs import report as REP
    from repro_torch.obs.__main__ import main as obs_main

    _, _, pdir, jdir = mclr_traced
    for report, d in ((JREP, pdir), (REP, jdir), (REP, pdir)):
        text = report.report_text(d)
        assert "== runs (1) ==" in text and "health: ok" in text
        assert "compile" in text and "dispatch" in text and "eval" in text
        art = report.load_artifacts(d)
        assert len(art["runs"]) == 1 and len(art["spans"]) == 1
    for main, d in ((j_obs_main, pdir), (obs_main, jdir), (obs_main, pdir)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["summarize", str(d)]) == 0
            assert main(["report", str(d)]) == 0
        assert "rounds=3" in out.getvalue() and "evals=2" in out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert obs_main(["summarize", str(jdir), str(pdir)]) == 0
    assert "final.pm" in out.getvalue()


def test_spans_of_a_traced_run(mclr_traced):
    from repro_torch.obs.report import load_artifacts

    _, _, pdir, _ = mclr_traced
    (trace,) = load_artifacts(pdir)["spans"]
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("build") == 1 and names.count("compile") == 1
    assert names.count("dispatch") == 2 and names.count("eval") == 2
    assert all(e["ph"] == "X" and e["dur"] >= 0
               for e in trace["traceEvents"])


# ------------------------------------------------ quad: comm, baselines, cohort

def test_compressed_run_residual_probes_match_the_reference(quad_data):
    jres = j_run_quad("permfl_topk", quad_data, rounds=3, seed=1,
                      trace=JTraceConfig())
    res = run_quad("permfl_topk", quad_data, rounds=3, seed=1, trace=True)
    assert {"ef_dev_norm", "ef_team_norm"} <= set(res.trace.series)
    assert min(res.trace["ef_dev_norm"]) > 0
    assert min(res.trace["ef_team_norm"]) > 0
    assert_traces_match(res, jres, TOL_3)


@pytest.mark.parametrize("name", ["fedavg", "ditto"])
def test_baseline_probes_match_the_reference(quad_data, name):
    """A baseline inherits the base probes: the update norm, and the
    nonfinite counts of the state and of the round's update."""
    jres = j_run_quad(name, quad_data, rounds=2, trace=JTraceConfig())
    res = run_quad(name, quad_data, rounds=2, trace=True)
    assert res.trace.names() == ["update_norm"]
    assert res.health.names() == ["nonfinite_params", "nonfinite_update"]
    assert_traces_match(res, jres, TOL_3)


def test_cohort_run_probes_match_the_reference(quad_data):
    frac = dict(team_frac=0.67, device_frac=0.75)
    jres = j_run_quad("permfl", quad_data, rounds=3, seed=7, cohort=COHORT,
                      trace=JTraceConfig(), **frac)
    res = run_quad("permfl", quad_data, rounds=3, seed=7, cohort=COHORT,
                   masks=jax_masks(7, 3, M, COHORT, **frac),
                   cohort_indices=lambda t: jres.cohort_indices[t],
                   trace=True, **frac)
    assert res.participation == jres.participation
    assert_traces_match(res, jres, TOL_3)


def test_sweep_probes_match_the_reference(quad_data):
    from repro_torch.train.sweep import run_sweep

    grid = [{}, {"lam": 0.3}]
    d = jax.tree.map(jnp.asarray, quad_data)
    jsw = j_sweep(jax_algo("permfl"), grid, (0,),
                  jax.tree.map(jnp.asarray, P0), d, d, metric_fn=j_neg,
                  rounds=2, m=M, n=N, trace=JTraceConfig())
    sw = run_sweep(port_algo("permfl"), grid, (0,), P0, quad_data,
                   quad_data, metric_fn=neg, rounds=2, m=M, n=N,
                   trace=True, device="cpu")
    for res, jres in zip(sw, jsw):
        assert_traces_match(res, jres, TOL_3)


# ------------------------------------------------------ the port by itself

def _assert_runs_bit_equal(a, b):
    from repro_torch.train.store import state_fields

    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation",
              "cohort_indices"):
        assert getattr(a, f) == getattr(b, f), f
    fa, fb = dict(state_fields(a.state)), dict(state_fields(b.state))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        elif isinstance(v, torch.Generator):
            assert torch.equal(v.get_state(), fb[k].get_state()), k
        else:
            assert v == fb[k], k


@pytest.mark.parametrize("name,kw", [
    ("permfl", dict(team_frac=0.67, device_frac=0.75)),
    ("permfl_randk", {}),
    ("ditto", {}),
    ("permfl", dict(cohort=COHORT, team_frac=0.67)),
], ids=["sampled", "randk", "ditto", "cohort"])
def test_trace_leaves_the_trajectory_bit_identical(quad_data, name, kw):
    from repro_torch.obs import TraceConfig

    off = run_quad(name, quad_data, rounds=3, seed=2, **kw)
    on = run_quad(name, quad_data, rounds=3, seed=2,
                  trace=TraceConfig(cost_analysis=True), **kw)
    assert off.trace is None and off.health is None
    assert len(on.trace) == 3 and on.health.ok()
    assert on.trace.cost["flops"] >= 0
    _assert_runs_bit_equal(on, off)


def test_traced_sweep_is_bit_identical_and_per_config(quad_data):
    from repro_torch.train.sweep import run_sweep

    kw = dict(metric_fn=neg, rounds=2, m=M, n=N, device="cpu",
              team_frac=0.67, device_frac=0.75)
    grid = [{}, {"lam": 0.3}]
    off = run_sweep(port_algo("permfl"), grid, (0, 4), P0, quad_data,
                    quad_data, **kw)
    on = run_sweep(port_algo("permfl"), grid, (0, 4), P0, quad_data,
                   quad_data, trace=True, **kw)
    for a, b in zip(on, off):
        _assert_runs_bit_equal(a, b)
    solo = run_quad("permfl", quad_data, rounds=2, seed=4, trace=True,
                    team_frac=0.67, device_frac=0.75)
    assert_series_close(on[1].trace.series, solo.trace.series, TOL_3)


ROUND_ALGOS = ["permfl", "permfl_topk", "permfl_randk", "fedavg",
               "perfedavg", "pfedme", "ditto", "hsgd", "l2gd"]


@pytest.mark.parametrize("name", ROUND_ALGOS)
def test_round_leaves_its_input_state_unchanged(quad_data, name):
    """The update norm and the update detector read the state before a
    round after the round ran: ``round`` must not write into it."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.train.store import state_fields

    algo = port_algo(name)
    state = algo.init_state(params_from_numpy(P0), M, N)
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  v.get_state() if isinstance(v, torch.Generator) else v)
              for k, v in state_fields(state)}
    data = params_from_numpy(quad_data)
    tm = torch.tensor([1.0, 0.0, 1.0])
    dm = torch.ones(M, N)
    dm[0, 1] = 0.0
    new = algo.round(state, data, team_mask=tm, device_mask=dm)
    for k, v in state_fields(state):
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, before[k]), k
        elif isinstance(v, torch.Generator):
            assert torch.equal(v.get_state(), before[k]), k
        else:
            assert v == before[k], k
    assert not torch.equal(new.x, state.x)


# ---------------------------------------------------------------- fail-fast

BAD = dict(eta=1e30)          # the reference's BAD_HP: overflows at round 1


def test_fail_fast_names_the_same_round_as_the_reference(quad_data):
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.obs import HealthError, TraceConfig
    from repro_torch.train.engine import run_experiment

    with pytest.raises(JHealthError) as jerr:
        j_run(JPerMFL(j_quad, JHParams(**dict(QHP, **BAD))),
              jax.tree.map(jnp.asarray, P0),
              jax.tree.map(jnp.asarray, quad_data),
              jax.tree.map(jnp.asarray, quad_data), metric_fn=j_neg,
              rounds=4, m=M, n=N, trace=JTraceConfig(fail_fast=True))
    algo = PerMFL(quad, PerMFLHParams(**dict(QHP, **BAD)))
    with pytest.raises(HealthError) as err:
        run_experiment(algo, P0, quad_data, quad_data, metric_fn=neg,
                       rounds=4, m=M, n=N, device="cpu",
                       trace=TraceConfig(fail_fast=True))
    assert err.value.round_index == jerr.value.round_index == 1
    assert set(err.value.detectors) == set(jerr.value.detectors)
    assert "round 1 [permfl]" in str(err.value)


def test_health_report_without_fail_fast_names_the_round(quad_data):
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.train.engine import run_experiment

    algo = PerMFL(quad, PerMFLHParams(**dict(QHP, **BAD)))
    res = run_experiment(algo, P0, quad_data, quad_data, metric_fn=neg,
                         rounds=2, m=M, n=N, device="cpu", trace=True)
    assert res.health.first_bad_round() == 1 and not res.health.ok()
    assert res.health.summary()["series"]["nonfinite_params"][
        "fired_rounds"] == 2


def test_fail_fast_names_the_config_in_a_sweep(quad_data):
    from repro_torch.obs import HealthError, TraceConfig
    from repro_torch.train.sweep import run_sweep

    grid = [{}, BAD]
    d = jax.tree.map(jnp.asarray, quad_data)
    with pytest.raises(JHealthError, match="config 1") as jerr:
        j_sweep(jax_algo("permfl"), grid, (0,),
                jax.tree.map(jnp.asarray, P0), d, d, metric_fn=j_neg,
                rounds=3, m=M, n=N, trace=JTraceConfig(fail_fast=True))
    with pytest.raises(HealthError, match="config 1") as err:
        run_sweep(port_algo("permfl"), grid, (0,), P0, quad_data,
                  quad_data, metric_fn=neg, rounds=3, m=M, n=N,
                  trace=TraceConfig(fail_fast=True), device="cpu")
    assert err.value.round_index == jerr.value.round_index == 1


# ----------------------------------------------------- units: the host side

def test_prometheus_text_is_byte_equal_to_the_reference():
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    regs = (MetricsRegistry(), JRegistry())
    rng = np.random.default_rng(3)
    obs = rng.lognormal(size=37).tolist()
    for reg in regs:
        reg.counter("serving.requests").inc(512)
        reg.counter("serving.tier.device", encoding="int8").inc(403)
        reg.counter("serving.lru.hits").inc(7.5)
        reg.gauge("serving.cache_hit_rate").set(0.8125)
        h = reg.histogram("serving.replay.latency_ms", path="serve")
        for v in obs:
            h.observe(v)
        reg.histogram("empty")
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert json.dumps(regs[0].snapshot()) == json.dumps(regs[1].snapshot())
    with pytest.raises(ValueError):
        regs[0].counter("serving.requests").inc(-1)
    with pytest.raises(TypeError):
        regs[0].gauge("serving.requests")


def test_spans_are_null_without_an_active_log(tmp_path):
    from repro_torch.obs.spans import SpanLog, current_log, span

    assert current_log() is None
    with span("nothing") as sp:
        sp.set(x=1)
    log = SpanLog(meta={"who": "test"})
    with log.activate():
        assert current_log() is log
        with span("outer", a=1) as sp:
            with span("inner"):
                pass
            sp.set(late=2.5)
        with pytest.raises(RuntimeError):
            with SpanLog().activate():
                pass
    assert current_log() is None
    assert [(s.name, s.depth) for s in log.spans] == [("outer", 0),
                                                      ("inner", 1)]
    chrome = json.loads(log.save(tmp_path, "t/x").read_text())
    assert chrome["metadata"] == {"who": "test"}
    assert chrome["traceEvents"][0]["args"] == {"a": 1, "late": 2.5}
    assert log.summary()["inner"]["count"] == 1


def test_probe_helpers_match_the_reference():
    from repro.obs import probes as JPR
    from repro.obs.health import nonfinite_count as j_nonfinite
    from repro_torch.flat import Layout
    from repro_torch.obs import probes as PR
    from repro_torch.obs.health import nonfinite_count

    rng = np.random.default_rng(1)
    v = np.abs(rng.normal(size=(3, 4))).astype(np.float32)
    mask = (rng.random((3, 4)) < 0.5).astype(np.float32)
    for f in ("masked_mean", "masked_max"):
        np.testing.assert_allclose(
            getattr(PR, f)(torch.from_numpy(v), torch.from_numpy(mask)),
            getattr(JPR, f)(v, mask), **TOL_1)
    zero = np.zeros_like(mask)
    assert float(PR.masked_mean(torch.from_numpy(v),
                                torch.from_numpy(zero))) == 0.0
    # the config axis kept: one value per leading row
    np.testing.assert_allclose(
        PR.masked_mean(torch.from_numpy(v), torch.from_numpy(mask), 1),
        [float(JPR.masked_mean(v[i], mask[i])) for i in range(3)], **TOL_1)
    # nonfinite counts skip integer fields, generators and row padding
    tree = {"w": np.array([1.0, np.nan, np.inf], np.float32),
            "b": np.array([[0.0, -np.inf]], np.float32)}
    layout = Layout.of({"w": torch.zeros(3), "b": torch.zeros(1, 2)})
    rows = layout.flatten({k: torch.from_numpy(a) for k, a in tree.items()})
    rows[..., layout.size:] = float("nan")          # padding never counts
    state = {"rows": rows, "steps": torch.tensor([1, 2]),
             "gen": torch.Generator()}
    assert float(nonfinite_count(PR.float_tensors(state, layout))) == \
        float(j_nonfinite(tree)) == 3.0


# ----------------------------------------------------------------- the CLI

def _cli(argv):
    from repro_torch.scenarios.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


SMOKE = ["table1/mnist/mclr/permfl", "--smoke", "--device", "cpu"]


def test_cli_run_trace_dir(tmp_path):
    from repro_torch.obs.report import load_artifacts

    rc, out = _cli(["run", *SMOKE, "--trace-dir", str(tmp_path)])
    assert rc == 0 and "  health: ok" in out
    assert f"python -m repro_torch.obs report {tmp_path}" in out
    art = load_artifacts(tmp_path)
    assert len(art["runs"]) == 1 and art["health"]
    header = art["runs"][0][0]
    assert header["scenario"] == "table1/mnist/mclr/permfl"
    names = {e["name"] for e in art["spans"][0]["traceEvents"]}
    assert {"scenario_build", "data_build", "build", "compile", "dispatch",
            "eval"} <= names
    compile_span = next(e for e in art["spans"][0]["traceEvents"]
                        if e["name"] == "compile")
    assert compile_span["args"]["flops"] > 0
    rc, out = _cli(["run", *SMOKE, "--trace-dir", str(tmp_path), "--json"])
    rec = json.loads(out)
    assert rc == 0 and rec["health"]["ok"] and rec["events_path"]


@pytest.mark.parametrize("traced", [False, True])
def test_scenarios_cli_json_footer_matches_the_reference(tmp_path, traced):
    """``run --json`` prints the reference's run_footer: the same keys,
    the same metrics under ``final``, and ``device`` besides."""
    from repro.scenarios.__main__ import main as j_main

    trace = ["--trace-dir", str(tmp_path / "port")] if traced else []
    rc, out = _cli(["run", *SMOKE, *trace, "--json"])
    assert rc == 0
    ev = json.loads(out)
    j_out = io.StringIO()
    j_trace = ["--trace-dir", str(tmp_path / "ref")] if traced else []
    with contextlib.redirect_stdout(j_out):
        assert j_main(["run", "table1/mnist/mclr/permfl", "--smoke",
                       *j_trace, "--json"]) == 0
    j_ev = json.loads(j_out.getvalue().strip().splitlines()[-1])
    assert ev["event"] == j_ev["event"] == "run_footer"
    assert set(ev) - set(j_ev) == {"device"} and set(j_ev) <= set(ev)
    assert set(ev["final"]) == set(j_ev["final"]) == {"pm", "tm", "gm",
                                                      "train_loss"}
    assert ev["scenario"] == "table1/mnist/mclr/permfl"
    assert ev["spec_hash"] == j_ev["spec_hash"]
    if traced:
        from repro_torch.obs.__main__ import main as obs_main

        assert ev["events_path"].startswith(str(tmp_path / "port"))
        assert obs_main(["summarize", str(tmp_path / "port")]) == 0
        assert set(ev["probes"]) == set(j_ev["probes"])
        assert set(ev["health"]) == set(j_ev["health"])


def test_cli_run_fail_fast_exits_3():
    rc, out = _cli(["run", *SMOKE, "--fail-fast", "--hparam", "eta=1e30"])
    assert rc == 3
    assert "health check failed at round 1" in out


def test_cli_run_profile_dir(tmp_path):
    rc, out = _cli(["run", *SMOKE, "--profile-dir", str(tmp_path)])
    assert rc == 0 and "  health: ok" in out
    (trace,) = tmp_path.glob("torch-*.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)


def test_cli_serve_trace_dir(tmp_path):
    from repro_torch.obs.report import load_artifacts

    rc, out = _cli(["serve", *SMOKE, "--trace-dir", str(tmp_path),
                    "--encoding", "int8", "--unknown-frac", "0.2"])
    assert rc == 0 and "python -m repro_torch.obs report" in out
    prom = (tmp_path / "metrics-serve.prom").read_text()
    assert "# TYPE serving_requests counter\nserving_requests 512\n" in prom
    assert "serving_replay_latency_ms_count 8" in prom
    art = load_artifacts(tmp_path)
    tiers = {r["metric"]: r["value"] for r in art["metrics"]
             if r["metric"].startswith("serving.tier.")}
    assert sum(tiers.values()) == 512
    names = [e["name"] for e in art["spans"][0]["traceEvents"]]
    for name in ("compile", "store_export", "replay", "replay_stages"):
        assert name in names
    assert names.count("replay_batch") == 8
