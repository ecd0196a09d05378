"""Random keys — the one injectable source of the port's random draws.

The JAX package threads ``jax.random`` keys through the simulator
(split per chunk, per round, per step and per client; ``fold_in`` for the
reducer and per leaf). The port keeps that key *schedule* and changes only
what a key is. ``TorchKey`` is a 64-bit integer on the host: ``split`` and
``fold_in`` mix it with splitmix64, and a draw seeds a ``torch.Generator``
on the run's device from it. So a key's draws depend only on the key, not
on the order keys are drawn in — the per-leaf streaming reduce, which
visits leaves in reverse, draws the same bits as the blocking one — and no
draw waits for the device.

A key supplies three kinds of draw:

  * ``batch_indices(n_clients, batch, high)`` — one local step's uniform
    minibatch indices, ``(N, B)`` int64, for all N clients at once (the
    JAX package splits the step key per client; a replaying key may);
  * ``client_batch_indices(batch, high)`` — one client's step alone,
    ``(B,)`` int64, drawn straight from the step key with no per-client
    split (the event runtime's asynchronous job, as the JAX package's
    draws it);
  * ``bits(shape)`` — uniform 32-bit words for stochastic rounding,
    returned as int32 and read as uint32 by the quantize kernel.

Any object with these five methods can stand in (the parity tests pass
one that replays JAX's threefry draws).
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: a bijective 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class TorchKey:
    """Host-side counter key whose draws come from a seeded
    ``torch.Generator`` on ``device``."""

    __slots__ = ("key", "device")

    def __init__(self, seed: int, device="cpu", *, _raw: bool = False):
        self.device = torch.device(device)
        self.key = int(seed) & _MASK64 if _raw else _mix(int(seed) & _MASK64)

    def _child(self, salt: int) -> "TorchKey":
        return TorchKey(_mix(self.key ^ _mix(salt & _MASK64)), self.device,
                        _raw=True)

    def split(self, n: int) -> list:
        """n independent child keys."""
        return [self._child(2 * i + 1) for i in range(n)]

    def fold_in(self, data: int) -> "TorchKey":
        """A child key derived from an integer (leaf index, salt)."""
        return self._child(2 * (int(data) & 0x7FFFFFFFFFFFFFFF) + 2)

    def _generator(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.key & 0x7FFFFFFFFFFFFFFF)
        return g

    def batch_indices(self, n_clients: int, batch: int,
                      high: int) -> torch.Tensor:
        """Uniform minibatch indices in [0, high), shape (N, B), int64."""
        return torch.randint(0, high, (n_clients, batch),
                             generator=self._generator(),
                             device=self.device)

    def client_batch_indices(self, batch: int, high: int) -> torch.Tensor:
        """One client's uniform minibatch indices in [0, high), (B,),
        int64."""
        return torch.randint(0, high, (batch,), generator=self._generator(),
                             device=self.device)

    def bits(self, shape) -> torch.Tensor:
        """Uniform 32-bit words of ``shape``, carried as int32."""
        return torch.randint(-2 ** 31, 2 ** 31, tuple(shape),
                             dtype=torch.int32, generator=self._generator(),
                             device=self.device)
