"""SSD entry point: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain chunked version in ``ref.py``. There is no
other route and no fallback.

Both routes run inside one ``torch.autograd.Function``, as flash attention
does (``kernels/flash_attention/ops.py``), and the backward follows the
forward's route. On the card the forward keeps the kernel's C·Bᵀ and
entering-state scratch (saved for the backward, so a rematerialised layer
holds them only while it is recomputed), and the backward launches the
Hopper backward kernel (``kernel.ssd_bwd``), held to autograd of the plain
version at float32 accuracy: it sums in another order over split bf16
products. On the CPU, and for a traced (fake) tensor, the backward
recomputes the plain ``ssd_chunked_ref`` from the saved inputs and returns
its vector-Jacobian product, as the JAX package differentiates its own jnp
chunked scan (``src/repro/models/ssm.py:79``); its Pallas kernel has no VJP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref as R
from repro_torch.kernels.trace import is_fake
from repro_torch.obs.trace import layer


def plain_ssd(x, dt, A, B, C, chunk, initial_state=None):
    """The plain version, y in x's type and the final state in float32: the
    CPU route's forward, and what the backward differentiates on both
    routes."""
    y, state = R.ssd_chunked_ref(x, dt, A, B, C, chunk, initial_state)
    return y.to(x.dtype), state


def _route(x, dt, A, B, C, chunk, initial_state):
    """The forward off the card: a traced call's kernel op, or the CPU's
    plain version."""
    if is_fake(x):   # a trace: the kernel's op
        return K.ssd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cpu":
        raise ValueError(f"ssd: no route for device {x.device}")
    K.check_inputs(x, dt, A, B, C, chunk, initial_state)
    return plain_ssd(x, dt, A, B, C, chunk, initial_state)


def _aligned(t):
    """t contiguous and 16-byte aligned (a copy only where it is not)."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class SSD(torch.autograd.Function):
    """forward: the device's route; backward: on the card the backward
    kernel, from the saved inputs and the forward kernel's scratch;
    elsewhere ``plain_ssd`` recomputed from the saved inputs and
    differentiated, for y and the final state. Each runs in its profiler
    range, ``ssd.forward`` (the remat recompute too) and ``ssd.backward``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk):
        ctx.chunk = chunk
        # an output the loss does not reach (the final state, in training)
        # gets None, not a zero tensor to differentiate against
        ctx.set_materialize_grads(False)
        with layer("ssd.forward"):
            if x.device.type == "cuda" and not is_fake(x):
                y, state, cb, states = K.ssd(
                    x, dt, A, B, C, chunk=chunk,
                    initial_state=initial_state, keep_scratch=True)
                ctx.save_for_backward(x, dt, A, B, C, initial_state, cb,
                                      states, state)
                return y, state
            ctx.save_for_backward(x, dt, A, B, C, initial_state)
            return _route(x, dt, A, B, C, chunk, initial_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        grads = [None] * 6
        pairs = [(o, g) for o, g in enumerate((gy, gstate)) if g is not None]
        want = [i for i, t in enumerate(saved[:6])
                if t is not None and ctx.needs_input_grad[i]]
        if not pairs or not want:
            return (*grads, None)
        if len(saved) > 6:   # the card: the backward kernel
            with layer("ssd.backward"):
                got = K.ssd_bwd(*saved[:5], *saved[6:], _aligned(gy),
                                _aligned(gstate), chunk=ctx.chunk,
                                initial_state=saved[5])
            for i in want:
                grads[i] = got[i]
            return (*grads, None)
        with layer("ssd.backward"), torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(
                ctx.needs_input_grad[i]) for i, t in enumerate(saved[:6])]
            outs = plain_ssd(*ins[:5], ctx.chunk, ins[5])
            got = torch.autograd.grad([outs[o] for o, _ in pairs],
                                      [ins[i] for i in want],
                                      [g for _, g in pairs],
                                      allow_unused=True)
        for i, g in zip(want, got):
            # the final state does not reach C: its gradient is zero
            grads[i] = torch.zeros_like(saved[i]) if g is None else g
        return (*grads, None)


def ssd(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """x: (b,S,H,P)  dt: (b,S,H)  A: (H,)  B,C: (b,S,G,N), G dividing H;
    initial_state: None (a zero state) or (b,H,P,N) float32.

    Returns y (b,S,H,P) in x's type (float32 math) and the final state
    (b,H,P,N) float32, chunks of min(chunk, S) rows. Differentiable in
    every tensor input on both routes.
    """
    return SSD.apply(x, dt, A, B, C, initial_state, chunk)

