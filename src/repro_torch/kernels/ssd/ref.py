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
    # select, never multiply by a mask: exp of the upper triangle overflows
    L = torch.where(tri, torch.exp(diff), torch.zeros((), device=x.device))
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
