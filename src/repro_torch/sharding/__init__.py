"""Sharding rules: mesh axis names, DTensor placements, ``shard``."""
from repro_torch.sharding.rules import (DATA_AXIS, MODEL_AXIS, POD_AXIS, P,
                                        param_specs, shard, to_placements)

__all__ = ["shard", "param_specs", "to_placements", "P", "DATA_AXIS",
           "MODEL_AXIS", "POD_AXIS"]
