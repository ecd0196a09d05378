from repro_torch.kernels.fused_update.kernel import fused_sgd_update
from repro_torch.kernels.fused_update.ops import sgd_update_, tree_sgd_update_
from repro_torch.kernels.fused_update.ref import sgd_update_ref

__all__ = ["fused_sgd_update", "sgd_update_", "sgd_update_ref",
           "tree_sgd_update_"]
