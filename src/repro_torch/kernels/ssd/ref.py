"""Plain PyTorch versions of the SSD kernel, float32 math.

``ssd_ref`` is the exact sequential recurrence of the JAX package's oracle
(``src/repro/kernels/ssd/ref.py:16-38``):

    h_t = exp(dt_t·A) · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t

``ssd_chunked_ref`` is the chunked dual form of the JAX model
(``src/repro/models/ssm.py:69-141``): per chunk of Q rows the intra-chunk
term ``(C·Bᵀ ∘ L)·(x·dt)`` plus the decayed contribution of the state that
enters the chunk, and a recurrence over the chunks' states. Unlike the JAX
model it takes grouped B/C (G dividing H, repeated per head, as the Pallas
kernel takes them) and any S: the last chunk may be short. It is what a
CPU tensor runs and what the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import math

import torch


def _per_head(t, H: int):
    """(b, S, G, N) -> (b, S, H, N) float32, group g serving heads
    g·H/G .. (g+1)·H/G - 1."""
    return t.float().repeat_interleave(H // t.shape[2], dim=2)


def ssd_ref(x, dt, A, B, C, initial_state=None):
    """x: (b,S,H,P)  dt: (b,S,H)  A: (H,)  B,C: (b,S,G,N) with G dividing H.

    Returns y (b,S,H,P) float32 and the final state (b,H,P,N) float32.
    """
    b, S, H, P = x.shape
    N = B.shape[3]
    Bh, Ch = _per_head(B, H), _per_head(C, H)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float().clone())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])[..., None, None]
        h = h * decay + torch.einsum("bhp,bhn->bhpn",
                                     xf[:, t] * dtf[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_chunked_ref(x, dt, A, B, C, chunk: int, initial_state=None):
    """The chunked scan, chunks of Q = min(chunk, S) rows, from
    ``initial_state`` (b,H,P,N) or, if None, from a zero state.

    x: (b,S,H,P)  dt: (b,S,H)  A: (H,)  B,C: (b,S,G,N), G dividing H.
    Returns y (b,S,H,P) float32 and the final state (b,H,P,N) float32.

    A short last chunk is padded with dt = 0 and x = B = C = 0: a padded row
    has no decay (its dA is 0, so the chunk's cumulative sum stays at its
    last real row) and injects nothing, so the padded chunk computes exactly
    the short chunk's y rows and state.
    """
    b, S, H, P = x.shape
    N = B.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def blocks(t):   # (b, S, ...) -> (b, nc, Q, ...) float32, zero-padded
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape((b, nc, Q) + t.shape[2:])

    xs, dts = blocks(x), blocks(dt)
    Bc, Cc = blocks(_per_head(B, H)), blocks(_per_head(C, H))

    dA = torch.movedim(dts * A.float(), -1, 2)           # (b,nc,H,Q)
    cums = torch.cumsum(dA, dim=-1)
    diff = cums[..., :, None] - cums[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # mask before the exp, never multiply by a mask or select after it: exp
    # of the upper triangle overflows, and its gradient (0 · inf) is NaN
    L = torch.exp(torch.where(tri, diff,
                              torch.full((), -math.inf, device=x.device)))
    xdt = xs * dts[..., None]                             # (b,nc,Q,H,P)

    CB = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc)       # (b,nc,H,Q,Q)
    y = torch.einsum("bchqs,bcshp->bcqhp", CB * L, xdt)

    seg_end = torch.exp(cums[..., -1:] - cums)            # (b,nc,H,Q)
    states = torch.einsum("bcshp,bcshn,bchs->bchpn", xdt, Bc, seg_end)
    chunk_decay = torch.exp(cums[..., -1])                # (b,nc,H)

    state = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(entering, dim=1)                   # (b,nc,H,P,N)
    y = y + torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cc, prev, torch.exp(cums))
    return y.reshape(b, nc * Q, H, P)[:, :S], state


def ssd_chunked_vjp_ref(x, dt, A, B, C, chunk: int, initial_state=None,
                        gy=None, gstate=None):
    """The vector-Jacobian product of ``ssd_chunked_ref`` in the passes of
    the backward kernel (``csrc/ssd.cu``), float32 math: the kernel's
    algorithm in plain PyTorch, held to autograd by the CPU tests.

    gy: dL/dy (b,S,H,P) or None (zero); gstate: dL/d(final state)
    (b,H,P,N) or None (zero). Returns (dx, ddt, dA, dB, dC, d
    initial_state) in float32, the last None without an initial state.
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hg = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def blocks(t):   # (b, S, ...) -> (b, nc, Q, ...) float32, zero-padded
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape((b, nc, Q) + t.shape[2:])

    xs, dts, Bc, Cc = blocks(x), blocks(dt), blocks(B), blocks(C)
    dy = torch.zeros_like(xs) if gy is None else blocks(gy)
    Bh, Ch = (t.repeat_interleave(hg, dim=3) for t in (Bc, Cc))
    cums = torch.cumsum(torch.movedim(dts * A.float(), -1, 2), dim=-1)
    cl = cums[..., -1]                                    # (b,nc,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, cums[..., :, None] - cums[..., None, :],
                              torch.full((), -math.inf, device=x.device)))
    xdt = xs * dts[..., None]
    seg = torch.exp(cl[..., None] - cums)                 # (b,nc,H,Q)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc).repeat_interleave(hg, 2)
    # the entering states S_c, as the forward kernel leaves them
    zero = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    Sc = [zero if initial_state is None else initial_state.float()]
    chunk_states = torch.einsum("bcshp,bcshn,bchs->bchpn", xdt, Bh, seg)
    for c in range(nc - 1):
        Sc.append(Sc[-1] * torch.exp(cl[:, c])[..., None, None] +
                  chunk_states[:, c])
    Sc = torch.stack(Sc, 1)                               # (b,nc,H,P,N)

    # 1. reverse state passing; dSn[:, c] is dS_{c+1}
    local = torch.einsum("bchq,bcqhp,bcqhn->bchpn", torch.exp(cums), dy, Ch)
    dS = zero if gstate is None else gstate.float()
    dSn = [None] * nc
    for c in range(nc - 1, -1, -1):
        dSn[c] = dS
        dS = dS * torch.exp(cl[:, c])[..., None, None] + local[:, c]
    dSn = torch.stack(dSn, 1)
    # 2. dxdt, dx, y's state term, g, exp(cums_last) <dS_{c+1}, S_c>
    state_part = torch.einsum("bchs,bcshn,bchpn->bcshp", seg, Bh, dSn)
    dxdt = torch.einsum("bchqs,bcqhp->bcshp", CB * L, dy) + state_part
    yterm = torch.einsum("bcqhn,bchpn,bcqhp->bcqh", Ch, Sc, dy) * \
        torch.movedim(torch.exp(cums), 2, 3)
    g = (xdt * state_part).sum(-1)                        # (b,nc,Q,H)
    last = torch.exp(cl) * (dSn * Sc).sum((-1, -2))       # (b,nc,H)
    # 3. dCB per group; M's row and column sums per head
    dCBh = L * torch.einsum("bcqhp,bcshp->bchqs", dy, xdt)
    M = CB * dCBh
    dCB = dCBh.reshape(b, nc, G, hg, Q, Q).sum(3)
    # 4. dC and dB
    dC = torch.einsum("bcgqs,bcsgn->bcqgn", dCB, Bc) + torch.einsum(
        "bchq,bcqhp,bchpn->bcqhn", torch.exp(cums), dy, Sc).reshape(
            b, nc, Q, G, hg, N).sum(4)
    dB = torch.einsum("bcgqs,bcqgn->bcsgn", dCB, Cc) + torch.einsum(
        "bchs,bcshp,bchpn->bcshn", seg, xdt, dSn).reshape(
            b, nc, Q, G, hg, N).sum(4)
    # 5. the decay: both sums of M, and the seg term against the last row's
    dcums = torch.movedim(M.sum(-1) - M.sum(-2), 2, 3) + yterm - g
    for c in range(nc):
        qc = min(Q, S - c * Q)
        dcums[:, c, qc - 1] += g[:, c].sum(1) + last[:, c]
    ddA = torch.flip(torch.cumsum(torch.flip(dcums, [2]), 2), [2])
    ddt = (xs * dxdt).sum(-1) + A.float() * ddA
    dA = (dts * ddA).sum((0, 1, 2))

    def rows(t):   # (b, nc, Q, ...) -> (b, S, ...)
        return t.reshape((b, nc * Q) + t.shape[3:])[:, :S]

    dinit = None if initial_state is None else dS
    return (rows(dxdt * dts[..., None]), rows(ddt), dA, rows(dB), rows(dC),
            dinit)
