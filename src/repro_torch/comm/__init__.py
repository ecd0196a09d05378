# Communication round: pluggable reducers (dense / int8 / top-k with error
# feedback) and the α–β cost model that prices them.
from repro_torch.comm.cost import (
    NetworkModel,
    comm_summary,
    comm_summary_for,
    dense_bytes,
    round_bytes,
    round_time,
)
from repro_torch.comm.reducer import (
    DenseMean,
    QuantizedMean,
    Reducer,
    TopKMean,
    get_reducer,
    reduce_streaming,
    supports_leaf_bytes,
)

__all__ = [
    "DenseMean",
    "NetworkModel",
    "QuantizedMean",
    "Reducer",
    "TopKMean",
    "comm_summary",
    "comm_summary_for",
    "dense_bytes",
    "get_reducer",
    "reduce_streaming",
    "round_bytes",
    "round_time",
    "supports_leaf_bytes",
]
