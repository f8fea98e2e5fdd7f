"""`SCENARIOS` -- the registry of the scenarios the port runs.

The PerMFL paper cells: Table 1 (MCLR and the non-convex model on mnist,
fmnist, emnist10 and synthetic), Fig 2 (fmnist, MCLR and CNN) and the
compressed-uplink family (``comm/mnist/mclr/*``), each registered exactly
as in the reference, published numbers included.
Other names of the reference's registry are not ported yet and raise a
KeyError that says so.
"""
from __future__ import annotations

from repro_torch.comm import CommConfig
from repro_torch.scenarios.paper_refs import table1_ref
from repro_torch.scenarios.spec import (ALGO_METRICS, AlgoSpec, DataSpec,
                                        FLScenario, ModelSpec)

__all__ = ["SCENARIOS", "families", "get_scenario", "register"]

SCENARIOS: dict = {}

TABLE1_DATASETS = ("mnist", "fmnist", "emnist10", "synthetic")


def register(scenario: FLScenario) -> FLScenario:
    """Add ``scenario`` under its name; duplicate names are an error."""
    if scenario.name in SCENARIOS:
        raise ValueError(f"duplicate scenario name {scenario.name!r}")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name_or_spec) -> FLScenario:
    """Resolve a registry name, a spec dict, or an FLScenario."""
    if isinstance(name_or_spec, FLScenario):
        return name_or_spec
    if isinstance(name_or_spec, dict):
        return FLScenario.from_dict(name_or_spec)
    name = str(name_or_spec)
    if name in SCENARIOS:
        return SCENARIOS[name]
    raise KeyError(
        f"scenario {name!r} is not in the port's registry: it runs only "
        f"the cells {sorted(SCENARIOS)}; the rest of the "
        f"reference's scenarios are still to be ported (ROADMAP.md "
        f"queue 1)")


def families() -> list:
    """Sorted list of registered scenario families (name prefixes)."""
    return sorted({k.split("/")[0] for k in SCENARIOS})


def _image_data(dataset, **kw):
    if dataset in ("synthetic", "featshift"):
        return DataSpec(dataset=dataset, partitioner="tabular", **kw)
    return DataSpec(dataset=dataset, **kw)


def _register_table1():
    algo = "permfl"
    for ds in TABLE1_DATASETS:
        for convex in (True, False):
            kind = "mclr" if convex else ("dnn" if ds == "synthetic"
                                          else "cnn")
            ref = tuple(
                (m, v) for m in ALGO_METRICS[algo]
                if (v := table1_ref(ds, convex, f"{algo}_{m}"))
                is not None)
            register(FLScenario(
                name=f"table1/{ds}/{kind}/{algo}",
                data=_image_data(ds),
                model=ModelSpec(kind),
                algo=AlgoSpec(algo),
                rounds=60 if convex else 40,
                data_seed=0, family="table1", paper_ref=ref,
                notes="Table 1: PerMFL vs baselines on identical "
                      "non-IID partitions"))


def _register_fig2():
    for kind in ("mclr", "cnn"):
        register(FLScenario(
            name=f"fig2/fmnist/{kind}/permfl",
            data=DataSpec(dataset="fmnist"),
            model=ModelSpec(kind),
            algo=AlgoSpec("permfl"),
            rounds=40, data_seed=1, family="fig2",
            notes="Fig 2: convergence vs multi-tier SOTA"))


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


_register_table1()
_register_fig2()
_register_comm()
