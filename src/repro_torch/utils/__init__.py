# Tree helpers, random keys, weight conversion and structured logging.
from repro_torch.utils.tree import (
    tree_add,
    tree_scale,
    tree_mean_leading,
    tree_zeros_like,
    tree_stack_leading,
    tree_take,
    tree_l2_norm,
    tree_size,
    tree_bytes,
)
from repro_torch.utils.logging import get_logger

__all__ = [
    "tree_add",
    "tree_scale",
    "tree_mean_leading",
    "tree_zeros_like",
    "tree_stack_leading",
    "tree_take",
    "tree_l2_norm",
    "tree_size",
    "tree_bytes",
    "get_logger",
]
