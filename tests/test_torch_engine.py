"""The port's engine, trainer and scenario entry points: histories against
the JAX engine's (full participation, and sampled participation with the
JAX engine's own masks injected), eval cadence with a remainder chunk,
the CLI, and entry points that refuse to run without a card unless told
to use the CPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs.paper_dnn import CONFIG as J_DNN  # noqa: E402
from repro.configs.paper_mclr import CONFIG as J_MCLR  # noqa: E402
from repro.core import PerMFLHParams as JHParams  # noqa: E402
from repro.core.participation import sample_masks as j_sample_masks  # noqa: E402,E501
from repro.models import paper_models as JPM  # noqa: E402
from repro.train.fl_trainer import run_permfl as j_run_permfl  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = dict(k_team=2, l_local=2)
TOL_LOSS = dict(rtol=1e-4, atol=1e-4)


def _port_cfg(kind):
    from repro_torch.configs.paper_dnn import CONFIG as DNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    return {"dnn": DNN, "mclr": MCLR}[kind]


J_FNS = {kind: (lambda p, b, c=cfg: JPM.loss_fn(p, c, b),
                lambda p, b, c=cfg: JPM.accuracy(p, c, b))
         for kind, cfg in (("dnn", J_DNN), ("mclr", J_MCLR))}


def _batches(fd):
    return ({"x": fd.train_x, "y": fd.train_y},
            {"x": fd.val_x, "y": fd.val_y})


def _run_both(kind, fd, *, rounds, eval_every, team_frac=1.0,
              device_frac=1.0, seed=0):
    from repro_torch.core.permfl import PerMFLHParams
    from repro_torch.scenarios.spec import fns_for
    from repro_torch.train.fl_trainer import run_permfl

    m, n = fd.m_teams, fd.n_devices
    train, val = _batches(fd)
    cfg = {"dnn": J_DNN, "mclr": J_MCLR}[kind]
    params0 = JPM.init_params(jax.random.PRNGKey(3), cfg)
    jres = j_run_permfl(
        params0, jax.tree.map(jnp.asarray, train),
        jax.tree.map(jnp.asarray, val), loss_fn=J_FNS[kind][0],
        metric_fn=J_FNS[kind][1], hp=JHParams(**HP), rounds=rounds, m=m,
        n=n, team_frac=team_frac, device_frac=device_frac, seed=seed,
        eval_every=eval_every)
    masks = None
    if team_frac < 1.0 or device_frac < 1.0:
        # the JAX engine's mask chain: split the carried key every round
        key, chain = jax.random.PRNGKey(seed), []
        for _ in range(rounds):
            key, sub = jax.random.split(key)
            chain.append(tuple(np.asarray(a) for a in j_sample_masks(
                sub, m, n, team_frac=team_frac, device_frac=device_frac)))
        masks = chain.__getitem__
    loss, metric = fns_for(_port_cfg(kind))
    res = run_permfl(
        jax.tree.map(np.asarray, params0), train, val, loss_fn=loss,
        metric_fn=metric, hp=PerMFLHParams(**HP), rounds=rounds, m=m, n=n,
        team_frac=team_frac, device_frac=device_frac, seed=seed,
        eval_every=eval_every, masks=masks, device="cpu")
    return res, jres


def _assert_histories_close(res, jres, n_val):
    for metric in ("pm_acc", "tm_acc", "gm_acc"):
        got, want = getattr(res, metric), getattr(jres, metric)
        assert len(got) == len(want), metric
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1.0 / n_val + 1e-6, err_msg=metric)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, **TOL_LOSS)
    assert res.participation == jres.participation


def test_run_experiment_matches_jax_with_remainder_chunk(tabular_fed_data):
    """5 rounds, eval every 2: evals after rounds 2, 4 and 5."""
    from repro_torch.convert import to_numpy

    fd = tabular_fed_data
    res, jres = _run_both("dnn", fd, rounds=5, eval_every=2)
    assert len(res.pm_acc) == 3 and len(res.round_seconds) == 5
    _assert_histories_close(res, jres, fd.val_y.shape[-1])
    got = to_numpy(res.state)
    for tier in ("x", "w", "theta"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=tier),
            got[tier], getattr(jres.state, tier))


def test_sampled_participation_with_injected_masks_matches_jax(
        small_fed_data):
    fd = small_fed_data
    res, jres = _run_both("mclr", fd, rounds=3, eval_every=1,
                          team_frac=0.5, device_frac=0.5, seed=4)
    assert res.participation == [(2, 4)] * 3
    _assert_histories_close(res, jres, fd.val_y.shape[-1])


def test_sampled_masks_from_generator():
    from repro_torch.core.participation import sample_masks

    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        tm, dm = sample_masks(g, 4, 6, team_frac=0.5, device_frac=0.5)
        assert tm.sum() == 2 and tm.dtype == torch.float32
        assert torch.equal(dm.sum(1), 3.0 * tm)
    a = sample_masks(torch.Generator().manual_seed(9), 4, 6, team_frac=0.5)
    b = sample_masks(torch.Generator().manual_seed(9), 4, 6, team_frac=0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_engine_samples_masks_itself(small_fed_data):
    from repro_torch.scenarios import run_scenario
    from repro_torch.scenarios.spec import FLScenario, DataSpec

    s = FLScenario("t", data=DataSpec(m_teams=2, n_devices=3,
                                      samples_per_device=16),
                   team_frac=0.5, device_frac=0.5, rounds=2)
    res = run_scenario(s, seed=1, device="cpu")
    assert res.participation == [(1, 2), (1, 2)]
    assert len(res.pm_acc) == 2 and np.isfinite(res.train_loss).all()


def test_tree_hparams_match_the_reference():
    from repro.core import PerMFL as JPerMFL
    from repro_torch.core import PerMFL, PerMFLHParams

    kw = dict(alpha=0.02, eta=0.04, beta=0.5, lam=0.3, gamma=1.2)
    leaves, rebuild = PerMFL(None, PerMFLHParams(**kw)).tree_hparams()
    assert leaves == JPerMFL(None, JHParams(**kw)).tree_hparams()[0]
    algo = rebuild({"lam": 0.9})
    assert algo.hp.lam == 0.9 and algo.hp.alpha == 0.02


def test_eval_points():
    from repro_torch.train.engine import eval_points

    assert eval_points(5, 2) == [2, 4, 5]
    assert eval_points(4, 2) == [2, 4]
    assert eval_points(3, 1) == [1, 2, 3]


@pytest.mark.parametrize("arg", ["trace", "trace_dir"])
def test_unported_engine_options_raise(arg, tmp_path):
    """Run telemetry is ported: ``trace=`` and ``trace_dir=`` no longer
    raise, and each gives its product."""
    from repro_torch.scenarios import run_scenario
    from repro_torch.scenarios.spec import DataSpec, FLScenario

    s = FLScenario("t", data=DataSpec(m_teams=2, n_devices=3,
                                      samples_per_device=16), rounds=1)
    res = run_scenario(s, device="cpu",
                       **{arg: True if arg == "trace" else str(tmp_path)})
    if arg == "trace":
        assert len(res.trace) == 1 and res.health.ok()
    else:
        assert res.trace is None and res.events_path
        assert list(tmp_path.glob("spans-*.trace.json"))


def test_cli_run_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "run",
         "table1/mnist/mclr/permfl", "--rounds", "2", "--device", "cpu",
         "--trace-dir", str(tmp_path), "--json"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr
    import json

    from repro_torch.obs.events import read_jsonl
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["scenario"] == "table1/mnist/mclr/permfl"
    assert rec["device"] == "cpu"
    assert read_jsonl(rec["events_path"])[0]["rounds"] == 2
    assert 0.0 <= rec["final"]["pm"] <= 1.0


def test_entry_points_default_to_the_card():
    """Without device=, every entry point asks for CUDA, and on a machine
    with no card it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from repro_torch.core import PerMFL, PerMFLHParams
    from repro_torch.device import resolve_device
    from repro_torch.scenarios import build_scenario, run_scenario
    from repro_torch.train.engine import run_experiment
    from repro_torch.train.fl_trainer import run_permfl

    calls = [
        lambda: resolve_device(),
        lambda: build_scenario("table1/mnist/mclr/permfl"),
        lambda: run_scenario("table1/mnist/mclr/permfl", rounds=1),
        lambda: run_experiment(PerMFL(None, PerMFLHParams()), {}, {}, {},
                               metric_fn=None, rounds=1, m=1, n=1),
        lambda: run_permfl({}, {}, {}, loss_fn=None, metric_fn=None,
                           hp=PerMFLHParams(), rounds=1, m=1, n=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
