"""The control: the reference put in the program's place one precision
below the configuration's.

The configurations state bfloat16 weights and activations, so the control
runs every linear layer's product on float8 (e4m3) operands: each operand
scaled by its largest magnitude to the format's range, rounded to float8
and back, then multiplied in float32 (a float8 GEMM accumulates in float
32). The backward multiplies by the rounded operands too. Every other op
stays the reference's. A limit that passes this control is too loose.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a), _fp8(b))
