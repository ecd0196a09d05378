"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

``JaxKey`` is a random key for the port that replays the JAX package's
threefry draws: ``split`` / ``fold_in`` are ``jax.random``'s, a step's
minibatch indices are one ``randint`` per client key (as
``simulate._sample_batch`` draws them under vmap), and ``bits`` is
``jax.random.bits`` carried as int32. With it the port and the JAX
package see the same minibatches and the same stochastic-rounding bits.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _batch_indices(key, n_clients, batch, high):
    keys = jax.random.split(key, n_clients)
    return jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, high))(keys)


@functools.partial(jax.jit, static_argnums=(1,))
def _bits(key, shape):
    return jax.random.bits(key, shape, jnp.uint32)


class JaxKey:
    def __init__(self, key):
        self.key = key

    def split(self, n):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def batch_indices(self, n_clients, batch, high):
        idx = _batch_indices(self.key, n_clients, batch, high)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    def bits(self, shape):
        b = _bits(self.key, tuple(shape))
        return torch.from_numpy(np.asarray(b).view(np.int32).copy())


def bits_i32(bits_u32: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> the port's int32 carrier tensor."""
    return torch.from_numpy(np.ascontiguousarray(bits_u32).view(np.int32)
                            .copy())


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)

