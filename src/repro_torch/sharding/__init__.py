"""Partition specs of the port's trees on the one-card mesh (the port of
``repro/sharding/specs.py``). The reference's ``constrain.py`` (activation
sharding constraints under an active mesh) has no counterpart: on one
card every constraint is the identity."""
from repro_torch.sharding.specs import (P, batch_pspecs, cache_pspecs,
                                        fl_pspecs, param_pspecs, place,
                                        store_pspecs, sweep_pspecs,
                                        validate_pspecs)

__all__ = ["P", "batch_pspecs", "cache_pspecs", "fl_pspecs", "param_pspecs",
           "place", "store_pspecs", "sweep_pspecs", "validate_pspecs"]
