"""Fused update entry points: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain version in ``ref.py``. There is no other
route and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.fused_update import ref as R
from repro_torch.kernels.fused_update.kernel import (check_inputs,
                                                     fused_sgd_update)
from repro_torch.utils.tree import tree_flatten


def sgd_update_(p, m, g, *, eta: float, beta: float = 0.0, wd: float = 0.0):
    """Fused momentum-SGD update of one leaf, in place on p and m.

    Returns (p, m). On CUDA the update is one kernel launch over the whole
    (possibly stacked) leaf.
    """
    if p.device.type == "cuda":
        return fused_sgd_update(p, m, g, eta=eta, beta=beta, wd=wd)
    if p.device.type != "cpu":
        raise ValueError(f"sgd_update_: no route for device {p.device}")
    check_inputs(p, m, g)
    p2, m2 = R.sgd_update_ref(p, m, g, eta=eta, beta=beta, wd=wd)
    p.copy_(p2)
    m.copy_(m2)
    return p, m


def tree_sgd_update_(params, moments, grads, *, eta, beta=0.0, wd=0.0):
    """Fused update over a whole parameter tree, in place, leaf by leaf."""
    flat_p, treedef = tree_flatten(params)
    flat_m = treedef.flatten_up_to(moments)
    flat_g = treedef.flatten_up_to(grads)
    for p, m, g in zip(flat_p, flat_m, flat_g):
        sgd_update_(p, m, g, eta=eta, beta=beta, wd=wd)
    return params, moments
