"""SSD entry point: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain chunked version in ``ref.py``. There is no
other route and no fallback. Forward only: the serving path needs no
gradient.
"""
from __future__ import annotations

from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref as R


def ssd(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """x: (b,S,H,P)  dt: (b,S,H)  A: (H,)  B,C: (b,S,G,N), G dividing H;
    initial_state: None (a zero state) or (b,H,P,N) float32.

    Returns y (b,S,H,P) in x's type (float32 math) and the final state
    (b,H,P,N) float32, chunks of min(chunk, S) rows.
    """
    if x.device.type == "cuda":
        return K.ssd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cpu":
        raise ValueError(f"ssd: no route for device {x.device}")
    K.check_inputs(x, dt, A, B, C, chunk, initial_state)
    y, state = R.ssd_chunked_ref(x, dt, A, B, C, chunk, initial_state)
    return y.to(x.dtype), state
