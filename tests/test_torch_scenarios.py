"""The port's scenario layer against the JAX package's: the registry
(every name, each with the reference's ``spec_hash``, ``to_dict`` and
``paper_ref``), one scaled cell of each
PerMFL family beyond Table 1 and Fig 2 run for 2 rounds in both packages
(fig4's sampled masks injected from the reference's chain), the
Theorem-1/2 helpers of ``core/theory.py`` on fixed inputs, and the CLI's
``describe``, ``dump``, ``run --smoke`` and ``run --hparam``.

Tolerances: accuracies within one validation sample; train losses and
the final states rtol 1e-4 / atol 1e-4 (two rounds); the theory
helpers exactly (the same float64 arithmetic).
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import theory as JT  # noqa: E402
from repro.core.participation import sample_masks as j_sample_masks  # noqa: E402,E501
from repro.scenarios import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.scenarios import FLScenario as JFLScenario  # noqa: E402
from repro.scenarios import build_scenario as j_build  # noqa: E402
from repro.scenarios import run_scenario as j_run  # noqa: E402

TOL_N = dict(rtol=1e-4, atol=1e-4)
# PerMFL's inner loops cut for the CPU; every other field as registered
CUT = {"k_team": 2, "l_local": 2}


def test_registry_is_the_reference_minus_cohort():
    """Every name of the reference's registry, the cohort/* cells now
    included, with its hash, dict, published numbers and metrics."""
    from repro_torch.scenarios import SCENARIOS, families

    want = list(J_SCENARIOS)
    assert len(want) == 95
    assert list(SCENARIOS) == want
    for name, s in SCENARIOS.items():
        j = J_SCENARIOS[name]
        assert s.spec_hash() == j.spec_hash(), name
        assert s.to_dict() == j.to_dict(), name
        assert s.paper_ref == j.paper_ref, name
        assert s.algo.metrics == j.algo.metrics, name
    assert families() == sorted(
        {k.split("/")[0] for k in want})


def test_every_algorithm_builds_and_baselines_refuse_comm():
    from repro_torch.comm import CommConfig
    from repro_torch.core import baselines as B
    from repro_torch.scenarios import SCENARIOS
    from repro_torch.scenarios.spec import ALGO_METRICS, AlgoSpec

    assert set(ALGO_METRICS) == {"permfl", "fedavg", "perfedavg", "pfedme",
                                 "ditto", "hsgd", "l2gd"}
    for name in ALGO_METRICS:
        algo = AlgoSpec(name).build(None)
        assert algo.name == name
    ditto = SCENARIOS["table1/mnist/cnn/ditto"].algo.build(None)
    assert ditto == B.Ditto(None, lr=0.01, lam=0.5, local_steps=20)
    with pytest.raises(ValueError, match="PerMFL feature"):
        AlgoSpec("fedavg").build(None, comm=CommConfig("int8"))
    with pytest.raises(ValueError, match="no PerMFLHParams"):
        AlgoSpec("l2gd").hparams()


def test_cohort_names_wait_for_their_item_and_near_misses_are_listed():
    """The cohort/* names resolve to their registered cells (the cohort
    engine they waited for is ported); unknown names list near misses."""
    from repro_torch.scenarios import get_scenario

    for n, c in ((1000, 64), (10000, 64), (100000, 128), (1000000, 256)):
        s = get_scenario(f"cohort/virtual/n{n}")
        assert s.cohort_size == c and s.data.n_devices == n
    with pytest.raises(KeyError, match="cohort/virtual/n1000"):
        get_scenario("cohort/virtual/n7")
    with pytest.raises(KeyError, match="table2/mnist/worst"):
        get_scenario("table2/mnist/best")
    with pytest.raises(KeyError, match="families"):
        get_scenario("nope/x")


# ------------------------------------------------------ one cell a family

FAMILY_CELLS = ["table2/mnist/worst", "fig3/mnist/mclr",
                "fig4/mnist/mclr/both_25", "dirichlet/mnist/a0.1",
                "quantity/mnist/q25", "featshift/dnn/s2",
                "teams/worst/m8n20"]


def _jax_masks(s, seed, rounds):
    """The JAX engine's participation chain for ``s``: the carried key
    split once a round."""
    m, n = s.data.m_teams, s.data.n_devices
    key, chain = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        chain.append(tuple(np.asarray(a) for a in j_sample_masks(
            sub, m, n, team_frac=s.team_frac, device_frac=s.device_frac)))
    return chain.__getitem__


@pytest.mark.parametrize("name", FAMILY_CELLS)
def test_family_cell_matches_jax(name):
    """2 rounds of the cell at 2 teams x 3 devices x 16 samples (teams:
    4 x 5, so worst-case pools still split) through the port's build
    and engine and the reference's ``run_scenario``, from the
    reference's init."""
    from repro_torch.convert import to_numpy
    from repro_torch.scenarios import build_scenario
    from repro_torch.train.engine import run_experiment

    m, n = (4, 5) if name.startswith("teams/") else (2, 3)
    js = J_SCENARIOS[name].scaled(m_teams=m, n_devices=n,
                                  samples_per_device=16,
                                  algo_overrides=CUT)
    seed = 3
    jres = j_run(js, rounds=2, seed=seed, init_seed=0)
    params0 = jax.tree.map(np.asarray, j_build(js, seed=0).params0)
    b = build_scenario(js.to_dict(), seed=0, device="cpu")
    assert b.scenario.spec_hash() == js.spec_hash()
    sampled = js.team_frac < 1.0 or js.device_frac < 1.0
    res = run_experiment(
        b.algo, params0, b.train, b.val, metric_fn=b.metric_fn, rounds=2,
        m=b.m, n=b.n, team_frac=js.team_frac, device_frac=js.device_frac,
        seed=seed, masks=_jax_masks(js, seed, 2) if sampled else None,
        device="cpu")
    assert res.participation == jres.participation
    n_val = b.val["y"].shape[-1]
    for field in ("pm_acc", "tm_acc", "gm_acc"):
        np.testing.assert_allclose(getattr(res, field), getattr(jres, field),
                                   rtol=0, atol=1.0 / n_val + 1e-6,
                                   err_msg=field)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, **TOL_N)
    got = to_numpy(res.state)
    for tier in ("x", "w", "theta"):
        jax.tree.map(lambda a, w: np.testing.assert_allclose(
            a, np.asarray(w), err_msg=tier, **TOL_N),
            got[tier], getattr(jres.state, tier))


# ------------------------------------------------------------ theory

THEORY_CASES = {
    "strongly_convex_bounds": [((0.1, 1.0, 2.5, 6.25), {}),
                               ((0.1, 1.0, 1.0, 10.0), {}),
                               ((0.05, 0.3, 2.1, 4.3), {})],
    "nonconvex_bounds": [((1.0, 2.5, 6.0), {}), ((0.2, 3.0, 1.0), {})],
    "inner_iteration_schedule": [
        ((10,), dict(mu_f=0.1, l_f=1.0, lam=2.5, gamma=6.25, alpha=0.2,
                     eta=0.05, beta=0.01)),
        ((40,), dict(mu_f=0.05, l_f=0.7, lam=1.9, gamma=4.8, alpha=0.3,
                     eta=0.08, beta=0.02, c_k=0.5, c_l=2.0))],
    "pick_hparams_strongly_convex": [((0.05, 1.0), {}),
                                     ((0.1, 2.0), dict(safety=0.5))],
}


@pytest.mark.parametrize("fn", list(THEORY_CASES) + ["mclr_constants"])
def test_theory_equals_the_reference(fn):
    from repro_torch.core import theory as T

    if fn == "mclr_constants":
        x = np.random.default_rng(0).normal(size=(200, 4, 5)).astype(
            np.float32)
        cases = [((x, 0.05), {}), ((x[:50], 0.0), {})]
    else:
        cases = THEORY_CASES[fn]
    for args, kw in cases:
        got, want = getattr(T, fn)(*args, **kw), getattr(JT, fn)(*args, **kw)
        if hasattr(want, "__dataclass_fields__"):
            assert type(got).__name__ == type(want).__name__
            got, want = vars(got), vars(want)
        np.testing.assert_equal(got, want)


# ------------------------------------------------------------ CLI

def test_cli_describe_and_dump_round_trip(capsys):
    from repro_torch.scenarios import SCENARIOS, FLScenario
    from repro_torch.scenarios.__main__ import main

    assert main(["describe", "table1/mnist/cnn/pfedme"]) == 0
    out = capsys.readouterr().out
    s = SCENARIOS["table1/mnist/cnn/pfedme"]
    assert f"hash={s.spec_hash()}" in out and "pfedme" in out
    assert "inner_lr" in out and "repro_torch.scenarios run" in out
    assert main(["dump", "fig4/mnist/mclr/both_25"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert FLScenario.from_dict(d) == SCENARIOS["fig4/mnist/mclr/both_25"]
    assert JFLScenario.from_dict(d) == J_SCENARIOS[d["name"]]


def test_paper_hp_and_participation_modes_match_the_reference():
    """PAPER_HP (paper §4.1.4, the PerMFL defaults every scenario starts
    from) and the four participation modes (§3.1) as the reference's."""
    import dataclasses

    from repro.core.participation import MODES as J_MODES
    from repro.scenarios import PAPER_HP as J_PAPER_HP
    from repro_torch.core.participation import MODES
    from repro_torch.core.permfl import PerMFLHParams
    from repro_torch.scenarios import PAPER_HP, AlgoSpec

    assert isinstance(PAPER_HP, PerMFLHParams)
    assert dataclasses.asdict(PAPER_HP) == dataclasses.asdict(J_PAPER_HP)
    assert dataclasses.asdict(AlgoSpec("permfl").hparams()) == \
        dataclasses.asdict(PAPER_HP)
    assert MODES == J_MODES
    assert list(MODES) == ["full", "partial_devices", "partial_teams",
                           "partial_both"]


def test_cli_run_baseline_smoke_prints_only_its_metrics(capsys, tmp_path,
                                                        monkeypatch):
    import repro_torch.scenarios as scenarios
    from repro_torch.obs.events import read_jsonl
    from repro_torch.scenarios.__main__ import main

    assert main(["run", "table1/mnist/mclr/fedavg", "--smoke",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gm=" in out and "rounds=2" in out
    for absent in ("pm=", "tm=", "train_loss="):
        assert absent not in out
    runs = []
    run = scenarios.run_scenario
    monkeypatch.setattr(scenarios, "run_scenario",
                        lambda *a, **k: runs.append(run(*a, **k)) or runs[-1])
    assert main(["run", "table1/mnist/mclr/pfedme", "--smoke", "--device",
                 "cpu", "--trace-dir", str(tmp_path), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    final = set(rec["final"])
    assert {"pm", "gm"} <= final and not {"tm", "train_loss"} & final
    assert read_jsonl(rec["events_path"])[0]["rounds"] == 2
    assert runs[-1].participation[-1] == (2, 6)


def test_cli_run_hparam(capsys):
    from repro_torch.scenarios import SCENARIOS
    from repro_torch.scenarios.__main__ import main

    args = ["run", "table1/mnist/mclr/ditto", "--smoke", "--device", "cpu",
            "--json"]
    assert main(args + ["--hparam", "lr=0.05"]) == 0
    rec = json.loads(capsys.readouterr().out)
    want = SCENARIOS["table1/mnist/mclr/ditto"].scaled(
        m_teams=2, n_devices=3, samples_per_device=16, rounds=2,
        algo_overrides={"lr": 0.05})
    assert rec["spec_hash"] == want.spec_hash()
    assert main(args) == 0
    assert json.loads(capsys.readouterr().out)["spec_hash"] != \
        want.spec_hash()
    for bad in ("lr", "lr=fast", "nope=1", "local_steps=3"):
        assert main(args + ["--hparam", bad]) == 2
        assert capsys.readouterr().out.startswith("error:")
