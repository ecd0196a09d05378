"""Plain PyTorch version of the fused momentum-SGD update.

The update each client runs k times per communication round (Alg. 1
line 7), in float32, cast back to p's and m's types:

    g += wd·p;  m' = β·m + g;  p' = p − η·m'

The same op order as ``csrc/fused_update.cu`` and the JAX package's
``fused_update/ref.py``. CPU tensors take this path; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def sgd_update_ref(p, m, g, *, eta: float, beta: float = 0.0,
                   wd: float = 0.0):
    """Returns new (p', m'); p, m and g are not modified."""
    g32 = g.to(torch.float32)
    if wd:
        g32 = g32 + wd * p.to(torch.float32)
    m2 = beta * m.to(torch.float32) + g32
    p2 = p.to(torch.float32) - eta * m2
    return p2.to(p.dtype), m2.to(m.dtype)


def tree_sgd_update_ref(ps, ms, gs, *, eta: float, beta: float = 0.0,
                        wd: float = 0.0):
    """``sgd_update_ref`` over lists of leaves: returns new lists (p', m');
    nothing given is modified. The plain version of one multi-leaf launch."""
    out = [sgd_update_ref(p, m, g, eta=eta, beta=beta, wd=wd)
           for p, m, g in zip(ps, ms, gs)]
    return [p for p, _ in out], [m for _, m in out]
