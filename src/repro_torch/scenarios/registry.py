"""`SCENARIOS` -- the registry of the scenarios the port runs.

Every cell of the reference's registry, registered exactly as there
(names, specs, seeds, rounds, notes and published numbers; equal
``spec_hash``): Table 1 (MCLR and the non-convex model on mnist,
fmnist, emnist10 and synthetic, PerMFL and the six baselines), Table 2's
team structures, Figs 2, 3 and 4, the compressed-uplink family
(``comm/mnist/mclr/*``), the families beyond the paper -- Dirichlet
label skew, quantity skew, feature-shift tabular, and worst/average team
formation at larger (M, N) grids -- and the cohort engine's scale-out,
2 teams of 10^3 to 10^6 devices (``cohort/virtual/n*``).

Naming: ``{family}/{...}`` with the family as the first segment --
``table1/{dataset}/{model}/{algo}``, ``table2/{dataset}/{strategy}``,
``fig2/{dataset}/{model}/{algo}``, ``fig4/.../{mode}``,
``comm/.../{compressor}``, ``dirichlet/{dataset}/a{alpha}``,
``quantity/{dataset}/q{min_frac}``, ``featshift/{model}/s{shift}``,
``teams/{strategy}/m{M}n{N}``, ``cohort/virtual/n{N}``.

Registered ``rounds`` are the paper-scale budgets; runs override rounds
(and derive shrunken variants via ``FLScenario.scaled``) at run time.
"""
from __future__ import annotations

from repro_torch.comm import CommConfig
from repro_torch.scenarios.paper_refs import table1_ref
from repro_torch.scenarios.spec import (ALGO_METRICS, AlgoSpec, DataSpec,
                                        FLScenario, ModelSpec)

__all__ = ["SCENARIOS", "TABLE1_ALGOS", "TABLE1_DATASETS", "families",
           "get_scenario", "register"]

SCENARIOS: dict = {}

# the Table-1 suite (benchmarks iterate this order)
TABLE1_DATASETS = ("mnist", "fmnist", "emnist10", "synthetic")
TABLE1_ALGOS = ("permfl", "fedavg", "perfedavg", "pfedme", "ditto",
                "hsgd", "l2gd")


def register(scenario: FLScenario) -> FLScenario:
    """Add ``scenario`` under its name; duplicate names are an error."""
    if scenario.name in SCENARIOS:
        raise ValueError(f"duplicate scenario name {scenario.name!r}")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name_or_spec) -> FLScenario:
    """Resolve a registry name, a spec dict, or an FLScenario instance to
    the FLScenario itself (KeyError lists near misses for names)."""
    if isinstance(name_or_spec, FLScenario):
        return name_or_spec
    if isinstance(name_or_spec, dict):
        return FLScenario.from_dict(name_or_spec)
    name = str(name_or_spec)
    if name in SCENARIOS:
        return SCENARIOS[name]
    near = [k for k in SCENARIOS
            if name.split("/")[0] == k.split("/")[0]][:8]
    raise KeyError(f"unknown scenario {name!r}; "
                   + (f"same family: {near}" if near
                      else f"families: {sorted(families())}"))


def families() -> list:
    """Sorted list of registered scenario families (name prefixes)."""
    return sorted({k.split("/")[0] for k in SCENARIOS})


# ---------------------------------------------------------------------------
# paper cells
# ---------------------------------------------------------------------------

def _image_data(dataset, **kw):
    if dataset in ("synthetic", "featshift"):
        return DataSpec(dataset=dataset, partitioner="tabular", **kw)
    return DataSpec(dataset=dataset, **kw)


def _table1_algo(algo: str, convex: bool) -> AlgoSpec:
    """Table-1 constructor settings: device lr 0.03 (convex) / 0.01
    (non-convex); PerMFL keeps the paper §4.1.4 hyperparameters."""
    lr = 0.03 if convex else 0.01
    ov = {
        "permfl": {},
        "fedavg": {"lr": lr, "local_steps": 50},
        "perfedavg": {"lr": lr, "inner_lr": lr, "local_steps": 20},
        "pfedme": {"inner_lr": lr},
        "ditto": {"lr": lr, "local_steps": 20},
        "hsgd": {"lr": lr},
        "l2gd": {"lr": lr},
    }[algo]
    return AlgoSpec(algo, tuple(ov.items()))


def _register_table1():
    for ds in TABLE1_DATASETS:
        for convex in (True, False):
            kind = "mclr" if convex else ("dnn" if ds == "synthetic"
                                          else "cnn")
            for algo in TABLE1_ALGOS:
                ref = tuple(
                    (m, v) for m in ALGO_METRICS[algo]
                    if (v := table1_ref(ds, convex, f"{algo}_{m}"))
                    is not None)
                register(FLScenario(
                    name=f"table1/{ds}/{kind}/{algo}",
                    data=_image_data(ds),
                    model=ModelSpec(kind),
                    algo=_table1_algo(algo, convex),
                    rounds=60 if convex else 40,
                    data_seed=0, family="table1", paper_ref=ref,
                    notes="Table 1: PerMFL vs baselines on identical "
                          "non-IID partitions"))


def _register_table2():
    for ds in ("mnist", "fmnist"):
        for strategy in ("worst", "average"):
            register(FLScenario(
                name=f"table2/{ds}/{strategy}",
                data=DataSpec(dataset=ds, m_teams=2, n_devices=10,
                              strategy=strategy),
                rounds=30, data_seed=3, family="table2",
                notes="Table 2: team-formation ablation (PM robust, GM "
                      "degrades in the worst case)"))


def _register_fig2():
    for kind in ("mclr", "cnn"):
        lr = 0.03 if kind == "mclr" else 0.01
        for algo in ("permfl", "hsgd", "l2gd"):
            ov = () if algo == "permfl" else (("lr", lr),)
            register(FLScenario(
                name=f"fig2/fmnist/{kind}/{algo}",
                data=DataSpec(dataset="fmnist"),
                model=ModelSpec(kind),
                algo=AlgoSpec(algo, ov),
                rounds=40, data_seed=1, family="fig2",
                notes="Fig 2: convergence vs multi-tier SOTA"))


def _register_fig3_fig4():
    register(FLScenario(
        name="fig3/mnist/mclr",
        data=DataSpec(dataset="mnist"),
        rounds=20, data_seed=2, family="fig3",
        notes="Fig 3: beta/gamma/lambda sweep base — apply the grid via "
              "sweep_scenario"))
    for mode, tf, df in (("full", 1.0, 1.0), ("devices_50", 1.0, 0.5),
                         ("teams_50", 0.5, 1.0), ("both_25", 0.25, 0.25)):
        register(FLScenario(
            name=f"fig4/mnist/mclr/{mode}",
            data=DataSpec(dataset="mnist"),
            team_frac=tf, device_frac=df,
            rounds=40, data_seed=4, family="fig4",
            notes="Fig 4: partial team/device participation"))


def _register_comm():
    comms = [("uncompressed", None),
             ("identity", CommConfig("identity")),
             ("topk_10", CommConfig("topk", k_frac=0.1)),
             ("topk_25", CommConfig("topk", k_frac=0.25)),
             ("randk_10", CommConfig("randk", k_frac=0.1)),
             ("int8", CommConfig("int8")),
             ("sign", CommConfig("sign"))]
    for cname, ccfg in comms:
        register(FLScenario(
            name=f"comm/mnist/mclr/{cname}",
            data=DataSpec(dataset="mnist"),
            comm=ccfg,
            rounds=40, data_seed=6, family="comm",
            notes="accuracy-vs-MB tradeoff for the tiered comm subsystem"))


# ---------------------------------------------------------------------------
# new scenario families (beyond the paper)
# ---------------------------------------------------------------------------

def _register_dirichlet():
    """Dirichlet-style statistical heterogeneity (cf. Personalized FL for
    Statistical Heterogeneity): alpha sweeps from near-single-class
    devices to near-IID."""
    for ds, alphas in (("mnist", (0.1, 0.5, 1.0)), ("fmnist", (0.5,))):
        for a in alphas:
            register(FLScenario(
                name=f"dirichlet/{ds}/a{a:g}",
                data=DataSpec(dataset=ds, partitioner="dirichlet",
                              alpha=a),
                rounds=12, data_seed=10, family="dirichlet",
                notes=f"Dir({a:g}) per-device class mixes; alpha->0 is "
                      "harsher than the paper's 2-class skew"))


def _register_quantity():
    for ds, frac in (("mnist", 0.25), ("fmnist", 0.10)):
        register(FLScenario(
            name=f"quantity/{ds}/q{int(frac * 100)}",
            data=DataSpec(dataset=ds, partitioner="quantity",
                          min_frac=frac),
            rounds=12, data_seed=11, family="quantity",
            notes="power-law effective dataset sizes, IID classes"))


def _register_featshift():
    """Covariate shift with a shared concept (cf. Distributed
    Personalized Empirical Risk Minimization's shared/personal split)."""
    for kind, shifts in (("mclr", (0.5, 2.0)), ("dnn", (2.0,))):
        for s in shifts:
            register(FLScenario(
                name=f"featshift/{kind}/s{s:g}",
                data=DataSpec(dataset="featshift", partitioner="tabular",
                              shift=s),
                model=ModelSpec(kind),
                rounds=12, data_seed=12, family="featshift",
                notes="team-shifted features, shared labeling concept"))


def _register_team_grids():
    """Worst/average-case formation at larger (M, N) than the paper's
    2x10 ablation; n_per_class grows so worst-case single-class team
    pools aren't exhausted."""
    for m, n in ((6, 15), (8, 20)):
        for strategy in ("worst", "average"):
            register(FLScenario(
                name=f"teams/{strategy}/m{m}n{n}",
                data=DataSpec(dataset="mnist", m_teams=m, n_devices=n,
                              strategy=strategy, n_per_class=60 * n),
                rounds=20, data_seed=13, family="teams",
                notes=f"{strategy}-case formation at {m} teams x {n} "
                      "devices"))


def _register_cohort():
    """The cohort engine's scale-out: populations of 10^3 to 10^6 devices
    per team, of which a ``cohort_size`` slab is materialized each round,
    on the vectorized "virtual" dataset; PerMFL with shallow inner loops
    (the point is the scaling in N, not the paper's accuracy cells)."""
    algo = AlgoSpec("permfl", (("k_team", 2), ("l_local", 2)))
    for n, cohort, rounds in ((1_000, 64, 20), (10_000, 64, 10),
                              (100_000, 128, 10), (1_000_000, 256, 5)):
        register(FLScenario(
            name=f"cohort/virtual/n{n}",
            data=DataSpec(dataset="virtual", partitioner="tabular",
                          m_teams=2, n_devices=n, samples_per_device=8),
            algo=algo,
            cohort_size=cohort,
            rounds=rounds, data_seed=21, family="cohort",
            notes=f"sample-then-materialize: {cohort} of {n} devices "
                  "per team per round"))


_register_table1()
_register_table2()
_register_fig2()
_register_fig3_fig4()
_register_comm()
_register_dirichlet()
_register_quantity()
_register_featshift()
_register_team_grids()
_register_cohort()
