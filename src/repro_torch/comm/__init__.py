"""Tiered communication of the port: compressed uplinks with and without
error feedback, their per-sender residual state, and the per-tier byte
ledger."""
from repro_torch.comm.compressors import (LeafPlan, compress_flat,
                                          compress_flat_ef, compression_plan,
                                          leaf_k, leaf_plan, needs_uniforms)
from repro_torch.comm.config import (COMPRESSORS, CommConfig, CommState,
                                     init_comm_state)
from repro_torch.comm.ledger import (CommLedger, RoundBytes,
                                     compressed_leaf_bytes,
                                     downlink_uplink_bytes, full_leaf_bytes,
                                     model_bytes)

__all__ = ["COMPRESSORS", "CommConfig", "CommLedger", "CommState",
           "LeafPlan", "RoundBytes", "compress_flat", "compress_flat_ef",
           "compressed_leaf_bytes", "compression_plan",
           "downlink_uplink_bytes", "full_leaf_bytes",
           "init_comm_state",
           "leaf_k", "leaf_plan", "model_bytes", "needs_uniforms"]
