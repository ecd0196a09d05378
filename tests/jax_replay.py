"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

``JaxKey`` is a random key for the port that replays the JAX package's
threefry draws: ``split`` / ``fold_in`` are ``jax.random``'s, a step's
minibatch indices are one ``randint`` per client key (as
``simulate._sample_batch`` draws them under vmap), one client's alone a
``randint`` on the step key itself (as the event runtime's asynchronous
job draws them), and ``bits`` is ``jax.random.bits`` carried as int32. With it the port and the JAX
package see the same minibatches and the same stochastic-rounding bits.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _batch_indices(key, n_clients, batch, high):
    keys = jax.random.split(key, n_clients)
    return jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, high))(keys)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _client_batch_indices(key, batch, high):
    return jax.random.randint(key, (batch,), 0, high)


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

    def client_batch_indices(self, batch, high):
        idx = _client_batch_indices(self.key, batch, high)
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


def close_histories(got, want, tol):
    """Two (round, iteration, value) histories: the same records, values
    within ``tol`` absolute."""
    assert [(r.round, r.iteration) for r in got] == \
        [(r.round, r.iteration) for r in want]
    np.testing.assert_allclose([r.value for r in got],
                               [r.value for r in want], atol=tol, rtol=0)


def same_rounds_to_target(got, want, fstar, gaps):
    """The rounds at which each history first reaches ``fstar + gap``
    are equal for every gap, and at least one gap is reached."""
    from repro_torch.core.simulate import rounds_to_target

    reached = [rounds_to_target(want, fstar + g) for g in gaps]
    assert [rounds_to_target(got, fstar + g) for g in gaps] == reached
    assert any(r is not None for r in reached)


EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


def load_example(name: str):
    """Import ``examples_torch/<name>.py`` as a module (its ``main`` does
    not run: each script runs only under ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one intra-op torch thread (imported by the
    transformer-training parity tests, whose small ops gain nothing from
    more): the tier-1 run's test workers share the machine's cores, and a
    worker's thread team waiting on descheduled threads stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
