"""Faults planted under the timed path, which the check must refuse.

Each wraps the program's (train_step, sync_step) pair from
``core/local_sgd.build_train_steps``:

* ``unchanged``: a step that returns its state unchanged (it runs, and
  its loss is reported, but parameters and moments are put back);
* ``half_batch``: a step that leaves out half of each client's rows and
  takes the mean over the rest;
* ``no_round``: a round that averages nothing (the replicas' exchange
  left out).

``bench/test_bench_harness.py`` plants them at SMOKE size on the CPU and
``bench/calibrate.py --faults`` on the card at a cell's own size; the
benchmark's own runs never do.
"""
from __future__ import annotations

import contextlib
import functools


def _leaves(state):
    from bench.harness import _walk

    return [t for _, t in _walk({"p": state["params"], "o": state["opt"]})]


def unchanged(train_fn, sync_fn):
    def step(state, batch, eta):
        # kept on the host: a second copy of a full-width state would not
        # fit beside it on the card
        keep = [t.to("cpu", copy=True) for t in _leaves(state)]
        new, m = train_fn(state, batch, eta)
        for t, k in zip(_leaves(state), keep):
            t.copy_(k)
        return new, m
    return step, sync_fn


def half_batch(train_fn, sync_fn):
    def step(state, batch, eta):
        half = {k: v[:, : v.shape[1] // 2] for k, v in batch.items()}
        return train_fn(state, half, eta)
    return step, sync_fn


def no_round(train_fn, sync_fn):
    return train_fn, functools.wraps(sync_fn)(lambda state: state)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_round": no_round}


@contextlib.contextmanager
def planted(fault):
    """``core/local_sgd.build_train_steps`` returning ``fault``'s broken
    steps while the block runs."""
    from repro_torch.core import local_sgd as LS

    real = LS.build_train_steps

    def broken(*a, **k):
        train_fn, sync_fn, per_client = real(*a, **k)
        return (*fault(train_fn, sync_fn), per_client)

    LS.build_train_steps = broken
    try:
        yield
    finally:
        LS.build_train_steps = real
