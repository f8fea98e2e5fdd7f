"""The one-card mesh and the NVIDIA H100's constants for the roofline.

The reference lays its runs on TPU meshes: a pod (16, 16) = 256 v5e
chips over (data, model), two pods (2, 16, 16) over (pod, data, model),
and a sweep mesh (sweep, data, model). The port runs on one H100, so a
:class:`Mesh` keeps the reference's axis names and order but every axis
has size 1 and the mesh names one ``torch.device``. Nothing shrinks
quietly: a mesh larger than the one card raises, and
:func:`make_production_mesh` raises naming the cards it needs.

The constants are an H100 SXM5 80GB's at its 700 W limit, from NVIDIA's
data sheet (dense rates, no sparsity); a card set below 700 W runs
slower under load. Importing this module touches no CUDA state: only
:func:`hbm_capacity` asks the card, when called.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["EXP_RATE", "HBM_BW", "HBM_BYTES", "INSTRUCTION_RATE", "Mesh",
           "NVLINK_BW", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32",
           "PEAK_FLOPS_TF32", "SM_CLOCK_HZ", "SM_COUNT", "batch_axes",
           "hbm_capacity", "make_host_mesh", "make_production_mesh",
           "make_sweep_mesh", "mesh_batch_size"]

# H100 SXM5 80GB, NVIDIA's data sheet, 700 W
PEAK_FLOPS_BF16 = 989e12       # dense tensor core, bf16 / fp16
PEAK_FLOPS_TF32 = 495e12       # dense tensor core, tf32
PEAK_FLOPS_F32 = 67e12         # float32 on the CUDA cores
HBM_BW = 3.35e12               # bytes/s of HBM3
HBM_BYTES = 80e9               # HBM3 capacity
NVLINK_BW = 450e9              # bytes/s a direction (no traffic on one card)
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9           # boost clock
# exponentials a second: the special-function units issue 16 a clock per
# SM (compute capability 9.0)
EXP_RATE = 16 * SM_COUNT * SM_CLOCK_HZ
# instructions a second: each SM's four schedulers issue one warp
# instruction (32 lanes) a clock
INSTRUCTION_RATE = 128 * SM_COUNT * SM_CLOCK_HZ

_CARDS = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def hbm_capacity(device=None) -> float:
    """Bytes of device memory: the card's total where a card is present
    (``device``: its index or name, default the current one), else the
    data sheet's 80 GB."""
    if torch.cuda.is_available():
        dev = torch.device(DEFAULT_DEVICE if device is None else device)
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return HBM_BYTES


@dataclass(frozen=True)
class Mesh:
    """Named axes over one card: ``axis_names`` in the reference's order,
    ``axis_sizes`` (each 1) and the ``device`` every leaf lives on.
    ``shape`` maps each axis to its size, as a JAX mesh's does."""
    axis_names: tuple
    axis_sizes: tuple
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.size != 1:
            raise ValueError(
                f"a mesh of {self.size} devices {dict(self.shape)}: the port "
                f"runs on one card, so every axis has size 1")

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices the mesh spans."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's single-pod (data, model) = (16, 16) or multi-pod
    (pod, data, model) = (2, 16, 16) mesh: raises, naming the 256 or 512
    cards it needs, since the port runs on one."""
    shape, axes = _CARDS[bool(multi_pod)]
    raise ValueError(
        f"the {'multi-pod' if multi_pod else 'single-pod'} mesh {axes} = "
        f"{shape} needs {math.prod(shape)} cards; the port runs on one "
        f"(make_host_mesh)")


def make_sweep_mesh(n_sweep: int, *, n_data: int = 16, n_model: int = 16,
                    device=DEFAULT_DEVICE) -> Mesh:
    """(sweep, data, model) mesh for batched hyperparameter and seed
    sweeps: configs ride the sweep axis, each config's (M, N) state the
    (data, model) axes. Raises unless every size is 1 (one card)."""
    return Mesh(("sweep", "data", "model"), (n_sweep, n_data, n_model),
                resolve_device(device))


def batch_axes(mesh) -> tuple:
    """The axes the global batch shards over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_batch_size(mesh) -> int:
    """Devices the global batch spreads over (the product of
    :func:`batch_axes`' sizes)."""
    out = 1
    for a in batch_axes(mesh):
        out *= mesh.shape[a]
    return out


def make_host_mesh(n_data: int = 1, n_model: int = 1, n_sweep: int = None,
                   device=DEFAULT_DEVICE) -> Mesh:
    """The one-card mesh on ``device`` (default the card; raises without
    one): (data, model), or (sweep, data, model) when ``n_sweep`` is
    given. Sizes other than 1 raise."""
    if n_sweep is not None:
        return make_sweep_mesh(n_sweep, n_data=n_data, n_model=n_model,
                               device=device)
    return Mesh(("data", "model"), (n_data, n_model), resolve_device(device))
