"""SSD entry point: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain chunked version in ``ref.py``. There is no
other route and no fallback. Forward only, on both routes: the kernel has
no backward yet (ROADMAP queue 1: Mamba2 training), so a call that would
need one raises rather than return a result cut off from autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref as R


def ssd(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """x: (b,S,H,P)  dt: (b,S,H)  A: (H,)  B,C: (b,S,G,N), G dividing H;
    initial_state: None (a zero state) or (b,H,P,N) float32.

    Returns y (b,S,H,P) in x's type (float32 math) and the final state
    (b,H,P,N) float32, chunks of min(chunk, S) rows. Raises when grad
    mode is on and an input requires grad.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x, dt, A, B, C, initial_state)):
        raise RuntimeError(
            "ssd: the SSD scan has no backward yet (ROADMAP queue 1: Mamba2 "
            "training); call it under torch.no_grad() or on inputs that do "
            "not require grad")
    if x.device.type == "cuda":
        return K.ssd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cpu":
        raise ValueError(f"ssd: no route for device {x.device}")
    K.check_inputs(x, dt, A, B, C, chunk, initial_state)
    y, state = R.ssd_chunked_ref(x, dt, A, B, C, chunk, initial_state)
    return y.to(x.dtype), state
