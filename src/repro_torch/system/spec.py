"""``SystemSpec``: the frozen, serializable wall-clock system model.

The port's copy of the reference's ``repro.system.spec`` (field names,
defaults, validation, profiles and ``to_dict`` are the reference's). A
system model answers "how long does one global round take" for a
hierarchy of heterogeneous devices behind heterogeneous links: every
device has a compute rate, every device<->team link is a LAN link
(bandwidth + latency), every team<->server link a WAN link. Rates and
bandwidths are lognormal around the spec's means, drawn per round
(``repro_torch.system.simulate``), so nonzero sigmas model jitter and
stragglers and zero sigmas a deterministic world.

Every field but ``name`` is a float, and the spec splits like the
algorithms' hyperparameters (``tree_floats``): a sweep stacks several
profiles' floats into (C,) tensors and prices C worlds in one stacked
round (``repro_torch.train.sweep``).

``SYSTEM_PROFILES`` names four reference worlds: ``uniform``
(homogeneous fast links: time is pure accounting), ``lan-campus``,
``wan-cellular`` (cellular last hop, slow WAN, heavy jitter) and
``edge-iot`` (weak devices, thin links). ``deadline_s`` turns any of
them into a straggler-dropping world.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.comm.ledger import downlink_uplink_bytes
from repro_torch.flat import tree_leaves

__all__ = ["SYSTEM_PROFILES", "RoundWorkload", "SystemSpec", "get_profile",
           "workload_for"]


@dataclass(frozen=True)
class SystemSpec:
    """Per-device compute and per-tier link models, one frozen value.

    name: profile label (presentation only; excluded from ``skeleton()``).
    compute_gflops: mean per-device compute rate, GFLOP/s.
    compute_sigma: lognormal spread of the per-device rate (0 = uniform
        fleet; ~1 = order-of-magnitude stragglers), drawn per round.
    flops_per_param: FLOPs one local step spends per model parameter.
    lan_mbps / lan_sigma / lan_latency_ms: device<->team link: mean
        bandwidth (megabits/s), lognormal spread, one-way latency.
    wan_mbps / wan_sigma / wan_latency_ms: team<->server link.
    deadline_s: per-round straggler deadline in simulated seconds; a
        device whose critical chain would finish after it is dropped
        from the round's masks. 0 disables deadlines.
    """
    name: str = "uniform"
    compute_gflops: float = 10.0
    compute_sigma: float = 0.0
    flops_per_param: float = 6.0
    lan_mbps: float = 1000.0
    lan_sigma: float = 0.0
    lan_latency_ms: float = 1.0
    wan_mbps: float = 100.0
    wan_sigma: float = 0.0
    wan_latency_ms: float = 20.0
    deadline_s: float = 0.0

    def __post_init__(self):
        for f in ("compute_gflops", "flops_per_param", "lan_mbps",
                  "wan_mbps"):
            if not getattr(self, f) > 0:
                raise ValueError(f"{f} must be positive, got "
                                 f"{getattr(self, f)}")
        for f in ("compute_sigma", "lan_sigma", "wan_sigma",
                  "lan_latency_ms", "wan_latency_ms", "deadline_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got "
                                 f"{getattr(self, f)}")

    def tree_floats(self):
        """``(leaves, rebuild)``: every float field by name, and a function
        returning the spec with some of them replaced."""
        leaves = {f.name: float(getattr(self, f.name))
                  for f in dataclasses.fields(self) if f.name != "name"}

        def rebuild(values):
            return dataclasses.replace(self, **values)

        return leaves, rebuild

    def skeleton(self) -> "SystemSpec":
        """The value-independent structure: the spec with ``name``
        stripped and every float zeroed (bypassing validation). Profiles
        stack on one sweep axis iff their skeletons are equal."""
        s = object.__new__(SystemSpec)
        object.__setattr__(s, "name", "")
        for f in dataclasses.fields(self):
            if f.name != "name":
                object.__setattr__(s, f.name, 0.0)
        return s

    def with_deadline(self, seconds: float) -> "SystemSpec":
        """This profile with a per-round straggler deadline attached."""
        return dataclasses.replace(self, deadline_s=float(seconds))

    def to_dict(self) -> dict:
        """Plain JSON-able dict, key for key the reference's;
        ``from_dict`` inverts it exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SystemSpec":
        """Rebuild a spec from ``to_dict()`` output or hand-written JSON."""
        return cls(**d)


# the reference's four worlds: order-of-magnitude realistic bandwidths and
# latencies (gigabit campus LAN, LTE uplinks, LoRa-class IoT backhaul),
# sigmas growing as the fleet gets scrappier
SYSTEM_PROFILES = {
    "uniform": SystemSpec(name="uniform"),
    "lan-campus": SystemSpec(
        name="lan-campus", compute_gflops=5.0, compute_sigma=0.25,
        lan_mbps=1000.0, lan_sigma=0.1, lan_latency_ms=0.5,
        wan_mbps=200.0, wan_sigma=0.1, wan_latency_ms=10.0),
    "wan-cellular": SystemSpec(
        name="wan-cellular", compute_gflops=2.0, compute_sigma=0.5,
        lan_mbps=20.0, lan_sigma=0.5, lan_latency_ms=10.0,
        wan_mbps=5.0, wan_sigma=0.5, wan_latency_ms=80.0),
    "edge-iot": SystemSpec(
        name="edge-iot", compute_gflops=0.2, compute_sigma=1.0,
        lan_mbps=8.0, lan_sigma=0.5, lan_latency_ms=5.0,
        wan_mbps=2.0, wan_sigma=0.3, wan_latency_ms=40.0),
}


def get_profile(name_or_spec) -> SystemSpec:
    """A profile name, a spec dict, or a SystemSpec, as the spec (KeyError
    lists the profiles for an unknown name)."""
    if isinstance(name_or_spec, SystemSpec):
        return name_or_spec
    if isinstance(name_or_spec, dict):
        return SystemSpec.from_dict(name_or_spec)
    name = str(name_or_spec)
    if name not in SYSTEM_PROFILES:
        raise KeyError(f"unknown system profile {name!r}; "
                       f"known: {sorted(SYSTEM_PROFILES)}")
    return SYSTEM_PROFILES[name]


@dataclass(frozen=True)
class RoundWorkload:
    """The per-round shape of one algorithm on one model: loop counts and
    wire sizes.

    k_team: team iterations per global round (LAN phases).
    local_steps: device steps per team iteration (compute per phase).
    n_params: model parameters (the compute-work proxy).
    full_bytes / comp_bytes: fp32 downlink and compressed uplink size of
        one model or delta, from the byte model (``comm.ledger``), so
        every compressor changes simulated time, not just bytes.
    """
    k_team: int
    local_steps: int
    n_params: int
    full_bytes: int
    comp_bytes: int


def workload_for(algo, params) -> RoundWorkload:
    """The RoundWorkload of one algorithm instance on a model (a nested
    dict of tensors or arrays).

    Loop counts come from the algorithm's fields (``hp.k_team`` /
    ``hp.l_local`` for PerMFL, ``k_team`` / ``l_local`` for h-SGD and
    L2GD, ``local_steps`` for FedAvg, Per-FedAvg and Ditto,
    ``inner_steps * local_rounds`` for pFedMe), wire sizes from the byte
    model with the algorithm's CommConfig (None: fp32 both ways).
    """
    leaf_sizes = []
    for _, leaf in tree_leaves(params):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        leaf_sizes.append(n)
    full, comp = downlink_uplink_bytes(leaf_sizes,
                                       getattr(algo, "comm", None))
    src = getattr(algo, "hp", None) or algo
    k = int(getattr(src, "k_team", 1))
    for attr in ("l_local", "local_steps"):
        if hasattr(src, attr):
            steps = int(getattr(src, attr))
            break
    else:
        steps = int(getattr(src, "inner_steps", 1)) * \
            int(getattr(src, "local_rounds", 1))
    return RoundWorkload(k_team=k, local_steps=max(1, steps),
                         n_params=sum(leaf_sizes), full_bytes=full,
                         comp_bytes=comp)
