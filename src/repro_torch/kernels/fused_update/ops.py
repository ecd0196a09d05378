"""Fused update entry points: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain version in ``ref.py``. There is no other
route and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.fused_update import ref as R
from repro_torch.kernels.fused_update.kernel import (check_inputs,
                                                     fused_sgd_update_leaves)
from repro_torch.kernels.trace import is_fake
from repro_torch.utils.tree import tree_flatten


def sgd_update_(p, m, g, *, eta: float, beta: float = 0.0, wd: float = 0.0):
    """Fused momentum-SGD update of one leaf, in place on p and m.

    Returns (p, m). On CUDA the update is one kernel launch over the whole
    (possibly stacked) leaf.
    """
    return tree_sgd_update_(p, m, g, eta=eta, beta=beta, wd=wd)


def tree_sgd_update_(params, moments, grads, *, eta, beta=0.0, wd=0.0):
    """Fused update over a whole parameter tree, in place.

    On CUDA one kernel launch updates every leaf (per (p type, m type)
    pair and per 64 leaves); on the CPU the plain version does, leaf by
    leaf. Returns (params, moments), the same trees.
    """
    flat_p, treedef = tree_flatten(params)
    flat_m = treedef.flatten_up_to(moments)
    flat_g = treedef.flatten_up_to(grads)
    kinds = {"cuda" if is_fake(p) else p.device.type for p in flat_p}
    if kinds == {"cuda"}:   # (a trace's fake tensors: the kernel's op)
        fused_sgd_update_leaves(flat_p, flat_m, flat_g, eta=eta, beta=beta,
                                wd=wd)
        return params, moments
    if kinds != {"cpu"}:
        raise ValueError(f"tree_sgd_update_: no route for leaves on "
                         f"{sorted(kinds)}")
    for p, m, g in zip(flat_p, flat_m, flat_g):
        check_inputs(p, m, g)
    new_p, new_m = R.tree_sgd_update_ref(flat_p, flat_m, flat_g, eta=eta,
                                         beta=beta, wd=wd)
    for p, m, p2, m2 in zip(flat_p, flat_m, new_p, new_m):
        p.copy_(p2)
        m.copy_(m2)
    return params, moments
