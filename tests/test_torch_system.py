"""The port's wall-clock system simulator (``repro_torch.system``) against
the JAX package's (``repro.system``).

- ``SystemSpec``: every profile's ``to_dict`` the reference's, round
  trips, one skeleton, validation; ``workload_for`` equal for PerMFL,
  each baseline and each compressor.
- ``simulate_round`` fed the reference's ``sample_links`` draws: the
  round time within rtol 1e-6, the thinned masks and the drop counts
  exactly (a mask may flip only where a chain lies within 1e-6,
  relative, of the deadline); ``keep_fastest`` on ties and live rounds.
- The engine: whole timelines at a zero-sigma profile (whose draws equal
  the mean exactly in both packages) with and without a deadline that
  trips ``keep_fastest``, stacked and through the cohort engine; a
  wan-cellular run fed the reference's links, with and without a
  deadline; determinism, a no-deadline model leaving the trajectory
  bit-equal, a deadline run equal to a system-free run fed its thinned
  masks; sweep lanes over profiles equal to their solo runs.
- Scenarios and the CLI: a system spec's ``to_dict`` and hash, the
  runner's keep-the-spec's-own default, ``profiles`` and ``run
  --system --deadline``.

Tolerances: times rtol 1e-6 (the same float32 operations in the same
order; XLA may contract a multiply-add); accuracies within one
validation sample; losses and states rtol 1e-4, atol 1e-4 (the rounds'
tolerance of ROADMAP.md queue 3 after 3 rounds).
"""
import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import system as JS  # noqa: E402
from repro.comm import CommConfig as JCommConfig  # noqa: E402
from repro.core.participation import keep_fastest as j_keep_fastest  # noqa: E402,E501
from repro.core.participation import sample_masks as j_sample_masks  # noqa: E402,E501
from repro.scenarios import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.train.engine import _SYSTEM_SALT  # noqa: E402
from repro.train.engine import run_experiment as j_run  # noqa: E402

WL = dict(k_team=5, local_steps=10, n_params=7850, full_bytes=31400,
          comp_bytes=3200)
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(m_teams=2, n_devices=3, samples_per_device=16)
CELL = "table1/mnist/mclr/permfl"


def _leaves(profile, **over):
    spec = JS.get_profile(profile)
    if over:
        spec = dataclasses.replace(spec, **over)
    return spec.tree_floats()[0]


# --------------------------------------------------------------- the spec

def test_profiles_equal_the_reference():
    from repro_torch.system import SYSTEM_PROFILES, SystemSpec

    assert list(SYSTEM_PROFILES) == list(JS.SYSTEM_PROFILES)
    skels = set()
    for name, spec in SYSTEM_PROFILES.items():
        assert spec.to_dict() == JS.SYSTEM_PROFILES[name].to_dict()
        assert SystemSpec.from_dict(json.loads(json.dumps(
            spec.to_dict()))) == spec
        leaves, rebuild = spec.tree_floats()
        assert leaves == JS.SYSTEM_PROFILES[name].tree_floats()[0]
        assert rebuild(leaves) == spec
        skels.add(spec.skeleton())
    assert len(skels) == 1


def test_spec_validation_and_resolution():
    from repro_torch.system import SYSTEM_PROFILES, SystemSpec, get_profile

    with pytest.raises(ValueError):
        SystemSpec(wan_mbps=0.0)
    with pytest.raises(ValueError):
        SystemSpec(compute_sigma=-0.1)
    with pytest.raises(KeyError):
        get_profile("datacenter-nvlink")
    spec = SYSTEM_PROFILES["edge-iot"]
    assert get_profile(spec) is spec
    assert get_profile("edge-iot") == spec == get_profile(spec.to_dict())
    d = get_profile("uniform").with_deadline(3.5)
    assert d.deadline_s == 3.5
    assert d.to_dict() == JS.get_profile("uniform").with_deadline(
        3.5).to_dict()
    assert dataclasses.replace(d, deadline_s=0.0) == \
        SYSTEM_PROFILES["uniform"]


COMMS = [None, dict(compressor="identity"), dict(compressor="topk"),
         dict(compressor="topk", k_frac=0.25),
         dict(compressor="randk", error_feedback=False),
         dict(compressor="int8"), dict(compressor="sign")]


@pytest.mark.parametrize("algo", ["permfl", "fedavg", "perfedavg",
                                  "pfedme", "ditto", "hsgd", "l2gd"])
def test_workload_for_equals_the_reference(algo):
    from repro_torch.comm import CommConfig
    from repro_torch.scenarios import SCENARIOS
    from repro_torch.system import workload_for

    params = {"b": np.zeros(10, np.float32),
              "w": np.zeros((784, 10), np.float32)}
    jparams = jax.tree.map(jnp.asarray, params)
    name = f"table1/mnist/mclr/{algo}"
    for comm in (COMMS if algo == "permfl" else [None]):
        p = SCENARIOS[name].algo.build(
            None, comm=None if comm is None else CommConfig(**comm))
        j = J_SCENARIOS[name].algo.build(
            None, comm=None if comm is None else JCommConfig(**comm))
        got, want = workload_for(p, params), JS.workload_for(j, jparams)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), comm


# --------------------------------------------------------- simulate_round

def _near_deadline_flips(got, want, links, wl, leaves):
    """Entries where the two packages' thinned device masks differ must
    have a chain within 1e-6 (relative) of the deadline."""
    rate, lan, wan = (np.asarray(a, np.float64) for a in links)
    lan_lat = leaves["lan_latency_ms"] * 1e-3
    wan_lat = leaves["wan_latency_ms"] * 1e-3
    t_iter = (wl["local_steps"] * wl["n_params"]
              * leaves["flops_per_param"] / rate + 2 * lan_lat
              + (wl["full_bytes"] + wl["comp_bytes"]) / lan)
    chain = (wan_lat + wl["full_bytes"] / wan)[:, None] \
        + wl["k_team"] * t_iter + (wan_lat + wl["comp_bytes"] / wan)[:, None]
    dl = leaves["deadline_s"]
    for t, j in zip(*np.nonzero(got != want)):
        assert abs(chain[t, j] - dl) <= 1e-6 * dl, (t, j, chain[t, j])


@pytest.mark.parametrize("deadline", [0.0, 0.5, 1e-6])
@pytest.mark.parametrize("profile", ["uniform", "lan-campus",
                                     "wan-cellular", "edge-iot"])
def test_simulate_round_matches_the_reference(profile, deadline):
    from repro_torch.system import RoundWorkload, simulate_round

    wl = RoundWorkload(**WL)
    leaves = _leaves(profile, deadline_s=deadline)
    for seed, frac in ((0, 1.0), (1, 0.5)):
        tm, dm = j_sample_masks(jax.random.PRNGKey(seed), 4, 10,
                                team_frac=frac, device_frac=frac)
        key = jax.random.PRNGKey(100 + seed)
        want = JS.simulate_round(leaves, JS.RoundWorkload(**WL), key, tm, dm)
        links = [np.asarray(a) for a in JS.sample_links(leaves, key, 4, 10)]
        got = simulate_round(leaves, wl, [torch.from_numpy(a)
                                          for a in links],
                             torch.from_numpy(np.asarray(tm)),
                             torch.from_numpy(np.asarray(dm)))
        np.testing.assert_allclose(float(got[2]), float(want[2]),
                                   rtol=1e-6)
        if not np.array_equal(got[1].numpy(), np.asarray(want[1])):
            _near_deadline_flips(got[1].numpy(), np.asarray(want[1]), links,
                                 WL, leaves)
            continue
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
        if deadline == 0.0:
            assert torch.equal(got[1], torch.from_numpy(
                np.asarray(dm * tm[:, None])))


def test_deadline_drops_and_keeps_the_round_nonempty():
    from repro_torch.system import RoundWorkload, sample_links, \
        simulate_round

    tm, dm = torch.ones(4), torch.ones(4, 10)
    wl = RoundWorkload(**WL)
    leaves = _leaves("wan-cellular", deadline_s=0.5)
    links = sample_links(leaves, torch.Generator().manual_seed(0), 4, 10)
    tm2, dm2, t, dt, dd = simulate_round(leaves, wl, links, tm, dm)
    assert int(dd) > 0 and float(dm2.sum()) == 40 - int(dd)
    leaves = _leaves("wan-cellular", deadline_s=1e-6)
    tm3, dm3, t3, dt3, dd3 = simulate_round(leaves, wl, links, tm, dm)
    assert float(tm3.sum()) == 1.0 and float(dm3.sum()) == 1.0
    assert int(dt3) == 3 and int(dd3) == 39
    assert torch.equal(dm3.sum(1) > 0, tm3 > 0)


def test_sample_links_are_mean_preserving_draws():
    from repro_torch.system import sample_links

    leaves = _leaves("uniform")
    rate, lan, wan = sample_links(leaves, torch.Generator().manual_seed(3),
                                  2, 5)
    assert torch.equal(rate, torch.full((2, 5), 1e10))      # sigma 0
    assert torch.equal(wan, torch.full((2,), 100.0 * 125_000.0))
    a = sample_links(_leaves("edge-iot"), torch.Generator().manual_seed(3),
                     64, 512)
    b = sample_links(_leaves("edge-iot"), torch.Generator().manual_seed(3),
                     64, 512)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # E[rate] = compute_gflops * 1e9 (sigma 1: ~1% over 32k draws)
    assert abs(float(a[0].double().mean()) / 0.2e9 - 1.0) < 0.05


@pytest.mark.parametrize("case", ["alive", "dead", "ties", "stacked"])
def test_keep_fastest_matches_the_reference(case):
    from repro_torch.core.participation import keep_fastest

    rng = np.random.default_rng(5)
    tm = np.array([1.0, 0.0, 1.0], np.float32)
    dm = (rng.random((3, 4)) > 0.5).astype(np.float32)
    score = rng.random((3, 4)).astype(np.float32)
    cand = np.ones((3, 4), np.float32)
    if case != "alive":
        dm[:] = 0.0
    if case == "ties":
        score[:] = 2.0
        cand[0, 0] = 0.0
    if case == "stacked":
        tms = np.stack([tm, np.ones(3, np.float32)])
        dms = np.stack([dm, (rng.random((3, 4)) > 0.5).astype(np.float32)])
        got = keep_fastest(*(torch.from_numpy(a) for a in
                             (tms, dms, np.stack([score] * 2),
                              np.stack([cand] * 2))))
        for i in range(2):
            want = j_keep_fastest(tms[i], dms[i], score, cand)
            assert np.array_equal(got[0][i].numpy(), np.asarray(want[0]))
            assert np.array_equal(got[1][i].numpy(), np.asarray(want[1]))
        return
    got = keep_fastest(*(torch.from_numpy(a) for a in (tm, dm, score, cand)))
    want = j_keep_fastest(tm, dm, score, cand)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------------- the engine

@functools.lru_cache(maxsize=None)
def _builds():
    """The reference's and the port's build of the scaled MCLR cell."""
    from repro.scenarios import build_scenario as j_build
    from repro_torch.scenarios import build_scenario

    s = J_SCENARIOS[CELL].scaled(**SMALL)
    jb = j_build(s)
    b = build_scenario(s.to_dict(), device="cpu")
    return jb, b


def _port_run(b, **kw):
    from repro_torch.train.engine import run_experiment
    args = dict(metric_fn=b.metric_fn, rounds=5, m=b.m, n=b.n,
                eval_every=2, device="cpu")
    args.update(kw)
    params = jax.tree.map(np.asarray, _builds()[0].params0)
    return run_experiment(b.algo, params, b.train, b.val, **args)


def _jax_run(jb, **kw):
    args = dict(metric_fn=jb.metric_fn, rounds=5, m=jb.m, n=jb.n,
                eval_every=2)
    args.update(kw)
    return j_run(jb.algo, jb.params0, jb.train, jb.val, **args)


def _assert_close_runs(res, jres, n_val):
    for f in ("pm_acc", "tm_acc", "gm_acc"):
        np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                   rtol=0, atol=1.0 / n_val + 1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, **TOL)
    assert res.participation == jres.participation
    np.testing.assert_allclose(res.timeline.round_seconds,
                               jres.timeline.round_seconds, rtol=1e-6)
    assert res.timeline.dropped_teams == jres.timeline.dropped_teams
    assert res.timeline.dropped_devices == jres.timeline.dropped_devices
    np.testing.assert_allclose(res.sim_seconds, jres.sim_seconds, rtol=1e-6)


@pytest.mark.parametrize("cohort", [None, 2])
@pytest.mark.parametrize("deadline", [0.0, 1e-6])
def test_zero_sigma_timelines_match_the_reference(deadline, cohort):
    """``uniform`` draws equal its means exactly in both packages; the
    1e-6 s deadline drops everyone, and keep_fastest keeps the first of
    the tied chains, (team 0, device 0)."""
    jb, b = _builds()
    sys = JS.get_profile("uniform").with_deadline(deadline)
    jres = _jax_run(jb, system=sys, cohort=cohort, seed=2)
    res = _port_run(b, system=sys.to_dict(), cohort=cohort, seed=2,
                    cohort_indices=None if cohort is None
                    else lambda t: jres.cohort_indices[t])
    _assert_close_runs(res, jres, jb.fd.val_y.shape[-1])
    if deadline:
        assert res.participation == [(1, 1)] * 5
        assert res.timeline.dropped_devices == [b.m * (cohort or b.n) - 1] * 5


def _jax_links(jb, leaves, seed, rounds, frac):
    """The reference engine's per-round links: the system stream split off
    the carried key (full participation) or folded out of the round's
    mask key (sampled)."""
    key, out, masks = jax.random.PRNGKey(seed), [], []
    for _ in range(rounds):
        if frac < 1.0:
            key, sub = jax.random.split(key)
            masks.append(tuple(np.asarray(a) for a in j_sample_masks(
                sub, jb.m, jb.n, team_frac=frac, device_frac=frac)))
            skey = jax.random.fold_in(sub, _SYSTEM_SALT)
        else:
            key, skey = jax.random.split(key)
        out.append([np.asarray(a) for a in
                    JS.sample_links(leaves, skey, jb.m, jb.n)])
    return out, masks


@pytest.mark.parametrize("profile,deadline,frac", [
    ("wan-cellular", 0.0, 1.0), ("wan-cellular", 0.0, 0.5),
    ("edge-iot", 0.6, 0.5)])
def test_engine_fed_the_reference_links_matches(profile, deadline, frac):
    jb, b = _builds()
    sys = JS.get_profile(profile).with_deadline(deadline)
    jres = _jax_run(jb, system=sys, team_frac=frac, device_frac=frac,
                    seed=3)
    links, masks = _jax_links(jb, sys.tree_floats()[0], 3, 5, frac)
    res = _port_run(b, system=profile if not deadline else sys.to_dict(),
                    team_frac=frac, device_frac=frac, seed=3,
                    links=links.__getitem__,
                    masks=masks.__getitem__ if masks else None)
    _assert_close_runs(res, jres, jb.fd.val_y.shape[-1])
    if deadline:
        assert sum(res.timeline.dropped_devices) > 0


def test_timeline_deterministic_and_monotone():
    _, b = _builds()
    r1 = _port_run(b, system="wan-cellular")
    r2 = _port_run(b, system="wan-cellular")
    assert r1.timeline == r2.timeline and r1.sim_seconds == r2.sim_seconds
    assert len(r1.timeline) == 5 and len(r1.sim_seconds) == 3
    assert all(t > 0 for t in r1.timeline.round_seconds)
    cum = r1.timeline.cum_seconds()
    assert (np.diff(cum) >= 0).all()
    assert r1.sim_seconds == [cum[1], cum[3], cum[4]]
    r3 = _port_run(b, system="wan-cellular", seed=1)
    assert r3.timeline.round_seconds != r1.timeline.round_seconds


@pytest.mark.parametrize("profile,frac", [("uniform", 1.0),
                                          ("lan-campus", 1.0),
                                          ("lan-campus", 0.5)])
def test_system_without_deadline_leaves_the_trajectory(profile, frac):
    _, b = _builds()
    kw = dict(team_frac=frac, device_frac=frac, seed=5)
    plain = _port_run(b, **kw)
    timed = _port_run(b, system=profile, **kw)
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        assert getattr(timed, f) == getattr(plain, f), f
    assert torch.equal(timed.state.theta, plain.state.theta)
    assert plain.timeline is None and plain.sim_seconds == []


def test_deadline_run_equals_a_run_fed_its_thinned_masks():
    """A deadline run equals the system-free engine fed, round by round,
    the masks the simulator thinned (replayed with the same links)."""
    from repro_torch.system import get_profile, simulate_round, \
        workload_for
    from repro_torch.system.simulate import sample_links

    _, b = _builds()
    sys = get_profile("edge-iot").with_deadline(0.6)
    leaves = sys.tree_floats()[0]
    gen = torch.Generator().manual_seed(8)
    links = [sample_links(leaves, gen, b.m, b.n) for _ in range(4)]
    res = _port_run(b, system=sys, team_frac=0.5, device_frac=0.5, seed=11,
                    rounds=4, eval_every=1, links=links.__getitem__)
    from repro_torch.core.participation import sample_masks
    mgen = torch.Generator().manual_seed(11)
    params = jax.tree.map(np.asarray, _builds()[0].params0)
    from repro_torch.convert import params_from_numpy
    wl = workload_for(b.algo, params_from_numpy(params))
    fed = []
    for t in range(4):
        tm, dm = sample_masks(mgen, b.m, b.n, team_frac=0.5,
                              device_frac=0.5)
        tm, dm, *_ = simulate_round(leaves, wl, links[t], tm, dm)
        fed.append((tm, dm))
    assert sum(res.timeline.dropped_devices) > 0
    plain = _port_run(b, team_frac=0.5, device_frac=0.5, rounds=4,
                      eval_every=1, masks=fed.__getitem__)
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        assert getattr(res, f) == getattr(plain, f), f
    assert torch.equal(res.state.theta, plain.state.theta)


def test_sweep_profile_lanes_equal_solo_runs():
    from repro_torch.train.sweep import run_sweep

    _, b = _builds()
    params = jax.tree.map(np.asarray, _builds()[0].params0)
    profiles = ["lan-campus", "wan-cellular", "edge-iot"]
    sw = run_sweep(b.algo, [{}], (0,), params, b.train, b.val,
                   metric_fn=b.metric_fn, rounds=3, m=b.m, n=b.n,
                   system=profiles, device="cpu")
    assert len(sw) == 3 and [c["system"] for c in sw.configs] == profiles
    for res, prof in zip(sw, profiles):
        solo = _port_run(b, system=prof, rounds=3, eval_every=1)
        assert res.pm_acc == solo.pm_acc and res.gm_acc == solo.gm_acc
        assert res.timeline == solo.timeline
        assert res.sim_seconds == solo.sim_seconds
    # per-config links injected: the same lanes
    from repro_torch.system import get_profile, sample_links
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    links = [[sample_links(get_profile(p).tree_floats()[0], g, b.m, b.n)
              for _ in range(3)] for p, g in zip(profiles, gens)]
    given = run_sweep(b.algo, [{}], (0,), params, b.train, b.val,
                      metric_fn=b.metric_fn, rounds=3, m=b.m, n=b.n,
                      system=profiles, device="cpu",
                      links=[ls.__getitem__ for ls in links])
    for res, prof, ls in zip(given, profiles, links):
        solo = _port_run(b, system=prof, rounds=3, eval_every=1,
                         links=ls.__getitem__)
        assert res.timeline == solo.timeline and res.pm_acc == solo.pm_acc
    one = run_sweep(b.algo, [dict(lam=0.3), dict(lam=0.8)], (0,), params,
                    b.train, b.val, metric_fn=b.metric_fn, rounds=2, m=b.m,
                    n=b.n, system="uniform", device="cpu")
    assert [r.timeline.profile for r in one] == ["uniform"] * 2
    assert one[0].timeline.round_seconds == one[1].timeline.round_seconds


def test_multi_sweep_prices_compressors():
    from repro_torch.comm import CommConfig
    from repro_torch.train.sweep import run_multi_sweep

    _, b = _builds()
    params = jax.tree.map(np.asarray, _builds()[0].params0)
    algos = [dataclasses.replace(b.algo, comm=CommConfig(compressor=c))
             for c in ("topk", "sign")]
    sweeps = run_multi_sweep(
        [dict(algo=a, params0=params,
              system=["lan-campus", "wan-cellular"]) for a in algos],
        b.train, b.val, metric_fn=b.metric_fn, rounds=2, m=b.m, n=b.n,
        device="cpu")
    for a, sw in zip(algos, sweeps):
        for res, prof in zip(sw, ("lan-campus", "wan-cellular")):
            from repro_torch.train.engine import run_experiment
            ref = run_experiment(a, params, b.train, b.val,
                                 metric_fn=b.metric_fn, rounds=2, m=b.m,
                                 n=b.n, system=prof, device="cpu")
            assert res.pm_acc == ref.pm_acc
            assert res.timeline == ref.timeline
            assert res.comm.total_bytes() == ref.comm.total_bytes()
    assert sweeps[1][1].timeline.total_seconds() < \
        sweeps[0][1].timeline.total_seconds()


# ------------------------------------------------ scenarios and the CLI

def test_scenario_system_serialization_and_hash():
    from repro_torch.scenarios import SCENARIOS, FLScenario
    from repro_torch.system import SYSTEM_PROFILES

    s = SCENARIOS[CELL]
    assert "system" not in s.to_dict()
    timed = s.with_system("wan-cellular")
    jtimed = J_SCENARIOS[CELL].with_system("wan-cellular")
    assert timed.system == SYSTEM_PROFILES["wan-cellular"]
    assert timed.to_dict() == jtimed.to_dict()
    assert timed.spec_hash() == jtimed.spec_hash() != s.spec_hash()
    assert FLScenario.from_dict(json.loads(json.dumps(
        timed.to_dict()))) == timed
    assert timed.with_system(None).spec_hash() == s.spec_hash()
    relabeled = timed.with_system(dataclasses.replace(timed.system,
                                                      name="renamed"))
    assert relabeled.spec_hash() == timed.spec_hash()
    assert timed.scaled(rounds=3).system == timed.system


def test_run_and_sweep_scenario_thread_system():
    from repro_torch.scenarios import SCENARIOS, run_scenario, \
        sweep_scenario

    s = SCENARIOS[CELL].scaled(**SMALL).with_system("wan-cellular")
    res = run_scenario(s, rounds=2, device="cpu")
    assert res.timeline.profile == "wan-cellular" and len(res.timeline) == 2
    res2 = run_scenario(s, rounds=2, system="lan-campus", device="cpu")
    assert res2.timeline.profile == "lan-campus"
    assert res2.timeline.total_seconds() < res.timeline.total_seconds()
    res3 = run_scenario(s, rounds=2, system=None, device="cpu")
    assert res3.timeline is None and res3.pm_acc == res.pm_acc
    sw = sweep_scenario(s, rounds=2, system=["lan-campus", "wan-cellular"],
                        device="cpu")
    assert [r.timeline.profile for r in sw] == ["lan-campus",
                                                "wan-cellular"]


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_profiles_and_system_run():
    from repro.scenarios.__main__ import main as j_main
    from repro_torch.scenarios.__main__ import main

    rc, out = _cli(main, ["profiles"])
    assert rc == 0 and out == _cli(j_main, ["profiles"])[1]
    rc, out = _cli(main, ["run", CELL, "--smoke", "--system",
                          "wan-cellular", "--deadline", "30", "--device",
                          "cpu"])
    assert rc == 0
    assert "system[wan-cellular]" in out and "simulated" in out
    rc, out = _cli(main, ["run", CELL, "--smoke", "--deadline", "30",
                          "--device", "cpu"])
    assert rc == 2 and "--deadline needs a system model" in out
    rc, out = _cli(main, ["describe", CELL])
    assert "system" not in out
