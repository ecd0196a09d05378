"""Launchers of the Hopper SSD chunked-scan kernels (``csrc/ssd.cu``).

``ssd`` replaces the Pallas TPU kernel ``src/repro/kernels/ssd/kernel.py:68``
(``ssd_chunked_kernel``): Mamba2's SSD scan from a zero or a given
initial state, y and the final state, at float32 accuracy. Per head and
chunk the work is the lower triangle of ``(C·Bᵀ ∘ L)·(x·dt)``, the state
term of y and the chunk's state, about 16 GFLOP per mamba2-2.7b layer at 4,096 tokens against
176 MB moved. The kernel runs every product on the tensor cores as three
bf16 products (a hi/lo split), so its bound on an H100 SXM is the larger
of the bytes over 3.35 TB/s and three times the work over 989 TFLOP/s.
One call launches two chunk-parallel kernels: C·Bᵀ once per (batch row,
group, chunk), then per (batch row, head, chunk) the chunk's state,
passed on from chunk to chunk, and the outputs. The wrapper allocates
their scratch. Any S is taken
(the last chunk may be short).

``ssd_bwd`` is the scan's vector-Jacobian product, which no TPU kernel
has (the Pallas kernel has no VJP): five chunk-parallel kernels on the
same three-pass products, which reuse the forward call's C·Bᵀ and
entering states and hold autograd of ``ref.ssd_chunked_ref`` to float32
accuracy (the sums run in another order). Its bound at mamba2-2.7b's
training cell is the bytes: 430 MB in float32, 0.128 ms.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import trace
from repro_torch.kernels.build import check, library
from repro_torch.kernels.trace import is_fake

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
D_STATES = (16, 32, 128)   # the Pallas tests' and mamba2-2.7b's
P_MULTIPLE = 16     # the kernel's m16 tiles of P
MAX_CHUNK = 256     # one cumulative-sum row per thread of a block
DCB_SPLIT = 4       # the backward's dCB pass cuts a group's heads in 4


def check_inputs(x, dt, A, B, C, chunk: int, initial_state=None):
    """Raise on shapes the scan does not define (both routes)."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssd: {name} must be a tensor")
        if t.device != x.device:
            raise ValueError(f"ssd: {name} is on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be (b, S, H, P), got {tuple(x.shape)}")
    b, S, H, P = x.shape
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"ssd: dt {tuple(dt.shape)} / A {tuple(A.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if B.dim() != 4 or B.shape != C.shape or tuple(B.shape[:2]) != (b, S):
        raise ValueError(f"ssd: B {tuple(B.shape)} / C {tuple(C.shape)} must "
                         f"both be (b, S, G, N) with x's b and S")
    G = B.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"ssd: {G} B/C groups do not divide {H} heads")
    if S < 1 or chunk < 1:
        raise ValueError(f"ssd: needs S >= 1 and chunk >= 1, got S={S}, "
                         f"chunk={chunk}")
    if initial_state is not None:
        want = (b, H, P, B.shape[3])
        if not isinstance(initial_state, torch.Tensor) or \
                tuple(initial_state.shape) != want or \
                initial_state.dtype != torch.float32 or \
                initial_state.device != x.device:
            raise ValueError(f"ssd: initial_state must be a float32 tensor "
                             f"of shape {want} on {x.device}")


def ssd(x, dt, A, B, C, *, chunk: int = 128, initial_state=None,
        keep_scratch: bool = False):
    """x: (b,S,H,P)  dt: (b,S,H) f32  A: (H,) f32  B,C: (b,S,G,N);
    initial_state: None (a zero state) or (b,H,P,N) f32, which the first
    chunk reads as the state entering it.

    Returns y (b,S,H,P) in x's type and the final state (b,H,P,N) float32,
    chunks of Q = min(chunk, S) rows; with ``keep_scratch`` also the
    kernel's C·Bᵀ and entering-state scratch, which ``ssd_bwd`` reads.
    CUDA tensors only, contiguous and 16-byte aligned; x, B and C all
    float32 or all bfloat16; P a multiple of 16, N in ``D_STATES``, Q at
    most 256. Anything else raises; nothing falls back.
    """
    check_inputs(x, dt, A, B, C, chunk, initial_state)
    if x.device.type != "cuda" and not is_fake(x):
        raise ValueError(f"ssd: the kernel takes CUDA tensors, got {x.device}")
    _check_kernel_shapes(x, dt, A, B, C, chunk, "ssd")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    if is_fake(x):   # a traced call: the op's shapes, nothing launched
        y, state = trace.ssd_op(x, dt, A, B, C, chunk, initial_state)
        return y, state
    _check_layout([("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                   ("initial_state", initial_state)], "ssd")
    y = torch.empty_like(x)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    # scratch: C·Bᵀ of every (batch row, group, chunk), Q padded to whole
    # 64-row tiles, and the state entering each chunk after the first
    # (float32); a ticket counter and one done-flag per (batch row, 64 rows
    # of P, head, chunk) for the state passing, zeroed by the launcher
    nc, QP = -(-S // Q), -(-Q // 64) * 64
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((b, G, nc, QP, QP), **f32)
    states = torch.empty((b, nc - 1, H, P, N), **f32)
    sync = torch.empty(1 + b * -(-P // 64) * H * nc, dtype=torch.int32,
                       device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_ssd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), cb.data_ptr(), states.data_ptr(), sync.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, S, H, P, G, N, Q,
            _DTYPE_CODE[x.dtype], stream)
    ssd.launches += 1
    check(status, "ssd")
    return (y, state, cb, states) if keep_scratch else (y, state)


ssd.launches = 0


def _check_kernel_shapes(x, dt, A, B, C, chunk: int, who: str):
    """Raise on types and sizes the kernels do not take (after
    ``check_inputs``)."""
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{who}: x, B, C must all be float32 or all "
                        f"bfloat16, got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{who}: dt and A must be float32, got "
                        f"{dt.dtype}/{A.dtype}")
    P, N = x.shape[3], B.shape[3]
    if P % P_MULTIPLE:
        raise ValueError(f"{who}: head dim {P} is not a multiple of "
                         f"{P_MULTIPLE}")
    if N not in D_STATES:
        raise ValueError(f"{who}: state dim {N} not in {D_STATES}")
    if min(chunk, x.shape[1]) > MAX_CHUNK:
        raise ValueError(f"{who}: chunk {min(chunk, x.shape[1])} exceeds "
                         f"{MAX_CHUNK}")


def _check_layout(named, who: str):
    """Raise unless every tensor given is contiguous and 16-byte aligned
    (the kernels load 16-byte vectors); None entries are skipped."""
    for name, t in named:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")


def ssd_bwd(x, dt, A, B, C, cb, states, state, gy, gstate, *,
            chunk: int = 128, initial_state=None):
    """The scan's vector-Jacobian product on the card.

    x, dt, A, B, C, ``chunk`` and ``initial_state`` as the forward call
    ``ssd(..., keep_scratch=True)`` took them; cb, states and state (the
    final state) what it returned. gy: dL/dy (b,S,H,P) in x's type, or None
    (zero); gstate: dL/d(final state) (b,H,P,N) float32, or None (zero).

    Returns (dx, ddt, dA, dB, dC, d initial_state): each gradient in its
    input's type, the last None without an initial state. CUDA tensors
    only, contiguous and 16-byte aligned, the shapes ``ssd`` takes;
    anything else raises. Five kernel launches, one call of the counter.
    """
    check_inputs(x, dt, A, B, C, chunk, initial_state)
    _check_kernel_shapes(x, dt, A, B, C, chunk, "ssd_bwd")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bwd: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    nc, QP, npt = -(-S // Q), -(-Q // 64) * 64, -(-P // 64)
    f32 = dict(dtype=torch.float32, device=x.device)
    want = {"cb": (cb, (b, G, nc, QP, QP)),
            "states": (states, (b, nc - 1, H, P, N)),
            "state": (state, (b, H, P, N))}
    if gstate is not None:
        want["gstate"] = (gstate, (b, H, P, N))
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or \
                t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"ssd_bwd: {name} must be a float32 tensor of "
                             f"shape {shape} on {x.device}")
    if gy is None:
        gy = torch.zeros_like(x)
    elif tuple(gy.shape) != tuple(x.shape) or gy.dtype != x.dtype or \
            gy.device != x.device:
        raise ValueError(f"ssd_bwd: gy must be {x.dtype} of shape "
                         f"{tuple(x.shape)} on {x.device}")
    _check_layout([("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                   ("initial_state", initial_state), ("cb", cb),
                   ("states", states), ("state", state), ("gy", gy),
                   ("gstate", gstate)], "ssd_bwd")
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    dinit = None if initial_state is None else torch.empty_like(initial_state)
    # scratch: each chunk's cumulative sums, dS entering the next chunk of
    # every chunk, dCB of every (batch row, group, chunk) in up to
    # DCB_SPLIT parts of the group's heads, and the decay's partial sums
    # (M's row and column sums per 64 rows or columns; per 64 of P x·dxdt,
    # y's state term and the seg term; exp(cums_last) <dS, S_c>); ticket
    # and done-flags as the forward's, zeroed by the launcher
    cums = torch.empty((b, nc, H, QP), **f32)
    dst = torch.empty((b, nc, H, P, N), **f32)
    dcb = torch.empty((b, G, min(DCB_SPLIT, H // G), nc, QP, QP), **f32)
    msum = torch.empty((b, nc, H, 2, QP // 64, QP), **f32)
    rpart = torch.empty((b, nc, H, npt, QP), **f32)
    ypart = torch.empty((b, nc, H, 2, npt, QP), **f32)
    dot = torch.empty((b, nc, H, npt), **f32)
    sync = torch.empty(1 + b * npt * H * nc, dtype=torch.int32,
                       device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_ssd_bwd(
            *map(ptr, (x, dt, A, B, C, cb, states, initial_state, state, gy,
                       gstate, cums, dst, dcb, msum, rpart, ypart, dot, sync,
                       dx, ddt, dA, dB, dC, dinit)),
            b, S, H, P, G, N, Q, _DTYPE_CODE[x.dtype], stream)
    ssd_bwd.launches += 1
    check(status, "ssd_bwd")
    return dx, ddt, dA, dB, dC, dinit


ssd_bwd.launches = 0
