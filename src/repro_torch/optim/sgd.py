"""Optimizers (dict/list trees of tensors, updated in place) + factory.

The port of ``src/repro/optim/sgd.py``. SGD(+momentum) is the paper's
optimizer; AdamW is provided for the LLM training examples. Both expose
(init, update) with one signature, so the Local-SGD step builder is
optimizer-agnostic. Optimizer state is averaged at communication rounds
alongside the parameters, so k=1 Local SGD equals SyncSGD.

Unlike the reference's pure functions, ``update`` writes the new
parameters and moments into the trees it is given (row views of the
stacked client replicas, in ``core/local_sgd.py``) and returns them.
``sgd_update`` is the fused momentum-SGD kernel (``kernels/fused_update``):
one launch for the whole tree on CUDA, its plain version on the CPU, in
the reference's order (g += wd·p; m' = β·m + g; p' = p − η·m'), float32
math for bf16 parameters with float32 moments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_update.ops import tree_sgd_update_
from repro_torch.utils.tree import tree_flatten, tree_map


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd_init(params):
    return {"mu": tree_map(_zeros32, params)}


def sgd_update(params, grads, state, *, eta, momentum: float = 0.0,
               weight_decay: float = 0.0):
    """In place on ``params`` and ``state["mu"]``; returns them.

    The kernel reads g in p's type or in float32: a float32 gradient of a
    bf16 parameter (an accumulated microbatch gradient) is added in
    float32, as the reference adds it.
    """
    grads = tree_map(
        lambda g, p: (g if g.dtype == torch.float32 else g.to(p.dtype))
        .contiguous(), grads, params)
    tree_sgd_update_(params, state["mu"], grads, eta=eta, beta=momentum,
                     wd=weight_decay)
    return params, state


def adamw_init(params):
    return {"m": tree_map(_zeros32, params), "v": tree_map(_zeros32, params),
            "t": torch.zeros((), dtype=torch.float32,
                             device=tree_flatten(params)[0][0].device)}


def adamw_update(params, grads, state, *, eta, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay: float = 0.0):
    """In place on ``params`` and ``state``; returns them. Plain ops."""
    t = state["t"] + 1.0
    flat_p, treedef = tree_flatten(params)
    for p, g, m, v in zip(flat_p, treedef.flatten_up_to(grads),
                          treedef.flatten_up_to(state["m"]),
                          treedef.flatten_up_to(state["v"])):
        g32 = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m2 / (1 - b1 ** t)
        vhat = v2 / (1 - b2 ** t)
        step = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            step = step + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - eta * step).to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    state["t"].copy_(t)
    return params, state


def make_optimizer(name: str, momentum: float = 0.0, weight_decay: float = 0.0):
    """Returns (init_fn, update_fn(params, grads, state, eta))."""
    if name == "sgd":
        def update(params, grads, state, eta):
            return sgd_update(params, grads, state, eta=eta,
                              momentum=momentum, weight_decay=weight_decay)
        return sgd_init, update
    if name == "adamw":
        def update(params, grads, state, eta):
            return adamw_update(params, grads, state, eta=eta,
                                weight_decay=weight_decay)
        return adamw_init, update
    raise ValueError(name)
