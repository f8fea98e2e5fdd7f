"""Launching the port on one H100: the card's constants and its one-card
mesh (:mod:`repro_torch.launch.mesh`), and the dry run of every
architecture and input shape on fake tensors
(``python -m repro_torch.launch.dryrun``)."""
from repro_torch.launch.mesh import (Mesh, batch_axes, hbm_capacity,
                                     make_host_mesh, make_production_mesh,
                                     make_sweep_mesh, mesh_batch_size)

__all__ = ["Mesh", "batch_axes", "hbm_capacity", "make_host_mesh",
           "make_production_mesh", "make_sweep_mesh", "mesh_batch_size"]
