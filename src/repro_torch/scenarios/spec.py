"""The declarative `FLScenario` spec: data x topology x model x algorithm
x participation x comm as one frozen, serializable value.

The port's copy of the reference's spec, for PerMFL and the six Table-1
baselines. ``to_dict()`` and ``spec_hash()`` equal the reference's for
every scenario, so a scenario names the same experiment in both
packages; the ``system`` and ``cohort_size`` keys appear only when set,
so a spec without them hashes as before.

    FLScenario
      ├── DataSpec   dataset + partitioner + (M, N) topology + team
      │              formation strategy + heterogeneity knobs
      ├── ModelSpec  which paper model (mclr | cnn | dnn)
      └── AlgoSpec   algorithm name + hyperparameter overrides
      plus rounds, team/device participation fractions, an optional
      CommConfig (compressed uplinks + byte accounting), an optional
      SystemSpec (the wall-clock model), an optional cohort width, the
      data seed, and presentation metadata (family, paper reference
      numbers, notes).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import CommConfig
from repro_torch.configs.base import PaperModelConfig
from repro_torch.core import PerMFL
from repro_torch.core import baselines as B
from repro_torch.core.permfl import PerMFLHParams
from repro_torch.data.federated import (FederatedData, partition_dirichlet,
                                        partition_label_skew,
                                        partition_quantity_skew,
                                        partition_tabular, stack_virtual)
from repro_torch.data.synthetic import (feature_shift_tabular, make_dataset,
                                        synthetic_tabular, virtual_tabular)
from repro_torch.models import paper_models as PM
from repro_torch.system import SystemSpec, get_profile

__all__ = ["ALGO_METRICS", "AlgoSpec", "DataSpec", "FLScenario",
           "ModelSpec", "PAPER_HP", "fns_for", "init_model", "to_torch"]

# metrics each algorithm reports (keys of FLAlgorithm.eval): the Table-1
# columns -- personalized/team/global for PerMFL, GM-only for the purely
# global baselines, PM+GM for the personalized ones
ALGO_METRICS = {
    "permfl": ("pm", "tm", "gm"),
    "fedavg": ("gm",),
    "perfedavg": ("pm", "gm"),
    "pfedme": ("pm", "gm"),
    "ditto": ("pm", "gm"),
    "hsgd": ("gm",),
    "l2gd": ("pm", "gm"),
}

_TABULAR_DATASETS = ("synthetic", "featshift", "virtual")
_PARTITIONERS = ("label_skew", "dirichlet", "quantity", "tabular")


def fns_for(cfg: PaperModelConfig):
    """(loss_fn, metric_fn) closures over one paper model config; both
    map (params with leaves (D, ...), batch (D, ...)) -> (D,)."""
    loss = lambda p, b: PM.loss_fn(p, cfg, b)
    met = lambda p, b: PM.accuracy(p, cfg, b)
    return loss, met


def init_model(cfg: PaperModelConfig, seed: int = 0):
    """Model parameters for ``cfg`` (on the CPU) from a ``torch.Generator``
    seeded with ``seed``. The draws differ from the reference's
    ``jax.random`` init; parity runs carry the reference's params over
    (``repro_torch.convert.params_from_numpy``)."""
    return PM.init_params(cfg, torch.Generator().manual_seed(seed))


def to_torch(fd: FederatedData, device="cpu"):
    """FederatedData -> (train, val) dicts of stacked tensors."""
    def batch(x, y):
        return {"x": torch.from_numpy(x).to(device),
                "y": torch.from_numpy(y).to(device)}
    return batch(fd.train_x, fd.train_y), batch(fd.val_x, fd.val_y)


# ---------------------------------------------------------------------------
# DataSpec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DataSpec:
    """What the federation holds: dataset, partitioner, and topology.

    dataset: "mnist" | "fmnist" | "emnist10" (image sets), "synthetic"
        (the paper's §D.2.6 tabular set), "featshift" (covariate-shift
        tabular), or "virtual" (its cohort-scale variant).
    partitioner: "label_skew" (paper §4.1.4), "dirichlet", "quantity", or
        "tabular" (implied by the tabular datasets).
    m_teams / n_devices: the (M, N) topology.
    samples_per_device: S -- stacked sample slots per device.
    classes_per_device: label-skew classes per device.
    strategy: team-formation label pools ("random" | "worst" | "average").
    alpha: Dirichlet concentration (partitioner="dirichlet").
    min_frac: minimum unique-sample fraction (partitioner="quantity").
    shift: team feature-shift magnitude (dataset="featshift").
    n_per_class: image-dataset pool size per class; 0 = 40 * n_devices.
    """
    dataset: str = "mnist"
    partitioner: str = "label_skew"
    m_teams: int = 4
    n_devices: int = 10
    samples_per_device: int = 48
    classes_per_device: int = 2
    strategy: str = "random"
    alpha: float = 0.5
    min_frac: float = 0.25
    shift: float = 2.0
    n_per_class: int = 0

    def __post_init__(self):
        if self.partitioner not in _PARTITIONERS:
            raise ValueError(f"unknown partitioner {self.partitioner!r}; "
                             f"expected one of {_PARTITIONERS}")
        if (self.dataset in _TABULAR_DATASETS) != \
                (self.partitioner == "tabular"):
            raise ValueError(
                f"partitioner 'tabular' and the tabular datasets "
                f"{_TABULAR_DATASETS} go together; got dataset="
                f"{self.dataset!r} with partitioner={self.partitioner!r}")

    def build(self, seed: int) -> FederatedData:
        """The stacked FederatedData for seed ``seed``: the same arrays,
        bit for bit, as the reference builds from the same spec."""
        rng = np.random.default_rng(seed)
        m, n, spd = self.m_teams, self.n_devices, self.samples_per_device
        if self.dataset == "synthetic":
            devs = synthetic_tabular(rng, m * n, min_samples=spd,
                                     max_samples=spd * 8)
            return partition_tabular(devs, m_teams=m, n_devices=n,
                                     samples_per_device=spd)
        if self.dataset == "featshift":
            devs = feature_shift_tabular(rng, m, n, shift=self.shift,
                                         samples_per_device=spd)
            return partition_tabular(devs, m_teams=m, n_devices=n,
                                     samples_per_device=spd)
        if self.dataset == "virtual":
            x, y = virtual_tabular(rng, m, n, shift=self.shift,
                                   samples_per_device=spd)
            return stack_virtual(x, y, samples_per_device=spd)
        x, y = make_dataset(self.dataset, rng,
                            n_per_class=self.n_per_class or 40 * n)
        if self.partitioner == "label_skew":
            return partition_label_skew(
                rng, x, y, m_teams=m, n_devices=n,
                classes_per_device=self.classes_per_device,
                samples_per_device=spd, strategy=self.strategy)
        if self.partitioner == "dirichlet":
            return partition_dirichlet(
                rng, x, y, m_teams=m, n_devices=n, alpha=self.alpha,
                samples_per_device=spd, strategy=self.strategy)
        return partition_quantity_skew(
            rng, x, y, m_teams=m, n_devices=n, samples_per_device=spd,
            min_frac=self.min_frac)


# ---------------------------------------------------------------------------
# ModelSpec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelSpec:
    """Which paper model trains on the scenario: "mclr" | "cnn" | "dnn".
    The input shape follows the dataset."""
    kind: str = "mclr"

    def config(self, data: DataSpec) -> PaperModelConfig:
        """Resolve to the concrete paper config for ``data``'s shapes."""
        from repro_torch.configs.paper_cnn import CONFIG as CNN
        from repro_torch.configs.paper_dnn import CONFIG as DNN
        from repro_torch.configs.paper_mclr import CONFIG as MCLR

        tabular = data.dataset in _TABULAR_DATASETS
        if self.kind == "mclr":
            return dataclasses.replace(MCLR, input_shape=(60,)) if tabular \
                else MCLR
        if self.kind == "dnn":
            return DNN
        if self.kind == "cnn":
            if tabular:
                raise ValueError("cnn needs image data, got "
                                 f"{data.dataset!r}")
            return CNN
        raise ValueError(f"unknown model kind {self.kind!r}")


# ---------------------------------------------------------------------------
# AlgoSpec
# ---------------------------------------------------------------------------

# paper §4.1.4 hyperparameters: the PerMFL defaults every scenario starts
# from (AlgoSpec overrides replace individual fields)
PAPER_HP = PerMFLHParams(alpha=0.01, eta=0.03, beta=0.6, lam=0.5,
                         gamma=1.5, k_team=5, l_local=10)

# paper-default constructor arguments per algorithm (Table-1 settings);
# AlgoSpec.overrides replaces individual entries
_ALGO_DEFAULTS = {
    "permfl": dataclasses.asdict(PAPER_HP),
    "fedavg": dict(lr=0.03, local_steps=50),
    "perfedavg": dict(lr=0.03, inner_lr=0.03, local_steps=20),
    "pfedme": dict(lr=1.0, inner_lr=0.03, lam=15.0, inner_steps=10,
                   local_rounds=5),
    "ditto": dict(lr=0.03, lam=0.5, local_steps=20),
    "hsgd": dict(lr=0.03, k_team=5, l_local=10),
    "l2gd": dict(lr=0.03, lam_c=0.5, lam_g=0.5, k_team=5, l_local=10),
}

_BASELINES = {"fedavg": B.FedAvg, "perfedavg": B.PerFedAvg,
              "pfedme": B.PFedMe, "ditto": B.Ditto, "hsgd": B.HSGD,
              "l2gd": B.L2GD}


@dataclass(frozen=True)
class AlgoSpec:
    """Algorithm name + hyperparameter overrides on the paper defaults.

    overrides: sorted tuple of (field, value) pairs replacing entries of
    the algorithm's paper-default constructor arguments (PerMFLHParams
    fields for "permfl", constructor kwargs for the baselines) -- a tuple
    so the spec stays hashable and JSON-round-trippable.
    """
    name: str = "permfl"
    overrides: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.name not in _ALGO_DEFAULTS:
            raise ValueError(f"unknown algorithm {self.name!r}; expected "
                             f"one of {sorted(_ALGO_DEFAULTS)}")
        unknown = set(dict(self.overrides)) - set(_ALGO_DEFAULTS[self.name])
        if unknown:
            raise ValueError(
                f"unknown {self.name} override(s) {sorted(unknown)}; "
                f"valid: {sorted(_ALGO_DEFAULTS[self.name])}")
        object.__setattr__(self, "overrides", tuple(
            sorted((str(k), v) for k, v in self.overrides)))

    def resolved(self) -> dict:
        """Paper defaults with this spec's overrides applied."""
        kw = dict(_ALGO_DEFAULTS[self.name])
        kw.update(dict(self.overrides))
        return kw

    def hparams(self) -> PerMFLHParams:
        """The resolved PerMFLHParams ("permfl" only)."""
        if self.name != "permfl":
            raise ValueError(f"{self.name} has no PerMFLHParams")
        return PerMFLHParams(**self.resolved())

    def build(self, loss_fn: Callable, comm: Optional[CommConfig] = None):
        """The frozen FLAlgorithm instance for the engine; ``comm``
        compresses PerMFL's uplinks (the baselines refuse it)."""
        kw = self.resolved()
        if self.name == "permfl":
            return PerMFL(loss_fn, PerMFLHParams(**kw), comm=comm)
        if comm is not None:
            raise ValueError(f"comm compression is a PerMFL feature; "
                             f"{self.name} does not route tiered uplinks")
        return _BASELINES[self.name](loss_fn, **kw)

    @property
    def metrics(self) -> tuple:
        """Eval metrics this algorithm reports (Table-1 columns)."""
        return ALGO_METRICS[self.name]


# ---------------------------------------------------------------------------
# FLScenario
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FLScenario:
    """One named, reproducible experiment.

    data / model / algo: the nested physical specs.
    rounds: default global-round budget (overridable at run time).
    team_frac / device_frac: participation fractions (paper §3.1 modes).
    comm: optional CommConfig -- compressed uplinks + byte accounting.
    system: optional SystemSpec -- the wall-clock model
        (``repro_torch.system``); results gain a Timeline and
        sim_seconds, and a deadline_s drops stragglers from the masks.
    cohort_size: optional per-team cohort width c -- the engine samples c
        of the N devices each round and materializes only the (M, c)
        slab (the cohort engine). None keeps the stacked path.
    data_seed: seed the federated partition is built from.
    family / paper_ref / notes: presentation metadata -- excluded from
        ``spec_hash()``. paper_ref holds (metric, paper accuracy %) pairs.
    """
    name: str
    data: DataSpec = field(default_factory=DataSpec)
    model: ModelSpec = field(default_factory=ModelSpec)
    algo: AlgoSpec = field(default_factory=AlgoSpec)
    rounds: int = 10
    team_frac: float = 1.0
    device_frac: float = 1.0
    comm: Optional[CommConfig] = None
    system: Optional[SystemSpec] = None
    cohort_size: Optional[int] = None
    data_seed: int = 0
    family: str = ""
    paper_ref: Tuple[Tuple[str, float], ...] = ()
    notes: str = ""

    def __post_init__(self):
        object.__setattr__(self, "paper_ref", tuple(
            (str(k), float(v)) for k, v in self.paper_ref))
        if self.cohort_size is not None and not (
                1 <= self.cohort_size <= self.data.n_devices):
            raise ValueError(
                f"cohort_size must be in [1, n_devices="
                f"{self.data.n_devices}], got {self.cohort_size}")

    def canonical(self) -> "FLScenario":
        """The physics only: presentation metadata stripped, the system
        profile's label with it (two equal profiles are one world)."""
        system = (dataclasses.replace(self.system, name="")
                  if self.system is not None else None)
        return dataclasses.replace(self, name="", family="", paper_ref=(),
                                   notes="", system=system)

    def spec_hash(self) -> str:
        """Stable 16-hex digest of the canonical spec (equal to the
        reference's for the same scenario)."""
        blob = json.dumps(self.canonical().to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        """Plain JSON-able dict, key for key the reference's (an
        uncompressed scenario carries ``"comm": None``; ``system`` and
        ``cohort_size`` appear only when set)."""
        d = {
            "name": self.name,
            "data": dataclasses.asdict(self.data),
            "model": dataclasses.asdict(self.model),
            "algo": {"name": self.algo.name,
                     "overrides": [[k, v] for k, v in self.algo.overrides]},
            "rounds": self.rounds,
            "team_frac": self.team_frac,
            "device_frac": self.device_frac,
            "comm": dataclasses.asdict(self.comm) if self.comm else None,
            "data_seed": self.data_seed,
            "family": self.family,
            "paper_ref": [[k, v] for k, v in self.paper_ref],
            "notes": self.notes,
        }
        if self.system is not None:
            d["system"] = self.system.to_dict()
        if self.cohort_size is not None:
            d["cohort_size"] = self.cohort_size
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FLScenario":
        """Rebuild a spec from ``to_dict()`` output (or the reference's);
        ``from_dict(to_dict(s)) == s``."""
        return cls(
            name=d["name"],
            data=DataSpec(**d["data"]),
            model=ModelSpec(**d["model"]),
            algo=AlgoSpec(d["algo"]["name"],
                          tuple(tuple(p) for p in d["algo"]["overrides"])),
            rounds=d["rounds"],
            team_frac=d["team_frac"],
            device_frac=d["device_frac"],
            comm=CommConfig(**d["comm"]) if d.get("comm") else None,
            system=(SystemSpec.from_dict(d["system"])
                    if d.get("system") else None),
            cohort_size=d.get("cohort_size"),
            data_seed=d["data_seed"],
            family=d.get("family", ""),
            paper_ref=tuple(tuple(p) for p in d.get("paper_ref", ())),
            notes=d.get("notes", ""),
        )

    def scaled(self, *, m_teams: Optional[int] = None,
               n_devices: Optional[int] = None,
               samples_per_device: Optional[int] = None,
               rounds: Optional[int] = None,
               cohort_size: Optional[int] = None,
               algo_overrides: Optional[dict] = None) -> "FLScenario":
        """A derived scenario at another scale; unset arguments keep the
        spec's values, ``algo_overrides`` merge over ``algo.overrides``.
        An inherited or given cohort_size is clamped to the (possibly
        shrunk) population."""
        data = dataclasses.replace(
            self.data,
            m_teams=m_teams if m_teams is not None else self.data.m_teams,
            n_devices=(n_devices if n_devices is not None
                       else self.data.n_devices),
            samples_per_device=(samples_per_device
                                if samples_per_device is not None
                                else self.data.samples_per_device))
        algo = self.algo
        if algo_overrides:
            merged = dict(algo.overrides)
            merged.update(algo_overrides)
            algo = AlgoSpec(algo.name, tuple(merged.items()))
        cohort = cohort_size if cohort_size is not None else self.cohort_size
        if cohort is not None:
            cohort = min(int(cohort), data.n_devices)
        return dataclasses.replace(
            self, data=data, algo=algo, cohort_size=cohort,
            rounds=rounds if rounds is not None else self.rounds)

    def with_system(self, profile) -> "FLScenario":
        """This scenario on a wall-clock system model: ``profile`` is a
        SystemSpec, a profile name ("wan-cellular", ...), a spec dict, or
        None to detach."""
        return dataclasses.replace(
            self, system=None if profile is None else get_profile(profile))

    def model_config(self) -> PaperModelConfig:
        """The resolved PaperModelConfig for this scenario's data."""
        return self.model.config(self.data)
