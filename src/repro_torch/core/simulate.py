"""N-client Local-SGD simulator on one device — the port's main path.

The engine behind the paper's convergence experiments (Tables 1–4): N
client replicas live on a stacked leading axis of every parameter leaf,
local steps run for all N clients at once (no communication), and a
communication round is an ``engine.Topology`` reduction over the leading
axis — a Star (or the per-leaf StreamingStar) over the configured
``comm`` reducer.

The JAX package vmaps one client's step; here the client axis is written
out. A local step

  1. draws every client's minibatch indices with one call, ``(N, B)``,
     and gathers the batch outside the vectorized gradient,
  2. takes all N gradients at once with
     ``torch.func.vmap(torch.func.grad(loss))`` over the stacked params
     and batches,
  3. updates each stacked leaf in place with the fused momentum-SGD
     kernel — one launch per leaf for all N clients.

After k steps the topology reduces the replicas (int8 rounds go through
the quantize and dequant_mean kernels) and the consensus is copied back
into every replica. The per-round objective values stay on the device
and are read once per chunk of rounds, as the JAX package's scan does.

Randomness goes through one key (``utils.rng``), split and folded in the
JAX package's schedule — per chunk, per round, per step, and
``fold_in(round, 0x5EED)`` then ``fold_in(·, leaf)`` for the reducer — so a
test can hand in a key that replays JAX's draws.

This slice runs the non-adaptive chunked path with every client present;
the masked (dropout) round and the divergence-triggered ``adaptive``
policy come with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.comm import get_reducer
from repro_torch.configs.base import TrainConfig
from repro_torch.core.prox import prox_loss
from repro_torch.engine.engine import Engine, StageStatus
from repro_torch.kernels.fused_update.ops import tree_sgd_update_
from repro_torch.obs.trace import CAT_COMPUTE
from repro_torch.utils.rng import TorchKey
from repro_torch.utils.tree import (tree_broadcast_leading, tree_flatten,
                                    tree_leaves, tree_map, tree_mean_leading,
                                    tree_to, tree_zeros_like)

# fold_in salt deriving the reducer's rng from the round rng without
# consuming it (the JAX package's _COMM_SALT).
_COMM_SALT = 0x5EED


@dataclass
class Record:
    round: int      # communication rounds so far
    iteration: int  # total iterations so far
    value: float    # eval_fn(averaged params)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for (explicitly or by
    default) and absent: the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_batch_weights(batch: int, grow: float, b0: int, max_batch: int,
                       device):
    """Per-example weight rule, as a function of the global step t.

    grow ≤ 1: uniform 1/batch. grow > 1 (CR-PSGD): bt = min(max, b0·grow^t)
    realised as a masked fixed-size buffer. Computed in float32 on the
    host, as the JAX package computes it in float32.
    """
    uniform = torch.ones((batch,), dtype=torch.float32,
                         device=device) / batch

    def batch_weights(t: np.float32):
        if grow <= 1.0:
            return uniform
        bt = np.minimum(np.float32(max_batch),
                        np.float32(b0) * np.float32(grow) ** np.float32(t))
        bt = np.clip(np.round(bt), 1, batch).astype(np.float32)
        mask = (np.arange(batch) < bt).astype(np.float32)
        return torch.from_numpy(mask / bt).to(device)

    return batch_weights


def _gather_batch(data, idx):
    """data: leaves (N, n, ...); idx: (N, B) -> leaves (N, B, ...)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda a: a[rows, idx], data)


def client_grads(loss_fn, params, batch, center, w):
    """All N clients' gradients at once: (N, …) params and (N, B, …)
    batches -> (N, …) gradients. ``loss_fn(params, batch, center, w)``."""
    return torch.func.vmap(
        torch.func.grad(lambda p, b: loss_fn(p, b, center, w)))(params,
                                                                batch)


def client_sgd_step(loss_fn, batch: int, momentum: float,
                    params, mom, data, key, center, w, eta_t: float):
    """One minibatch SGD(+momentum) step of all N clients, in place.

    ``params``/``mom`` are stacked (N, …) trees and are updated in place
    through the fused kernel (one launch per leaf); ``data`` leaves are
    (N, n, …). The single copy of the inner update math.
    """
    n_clients, n = tree_leaves(data)[0].shape[:2]
    idx = key.batch_indices(n_clients, batch, n)
    g = client_grads(loss_fn, params, _gather_batch(data, idx), center, w)
    return tree_sgd_update_(params, mom, g, eta=eta_t, beta=momentum)


def _eta_t(eta: float, lr_alpha: float, t: float) -> float:
    """η / (1 + α·t) in float32, as the JAX package computes it."""
    return float(np.float32(eta) / (np.float32(1.0)
                                    + np.float32(lr_alpha) * np.float32(t)))


def make_local_step_fn(loss_fn, *, batch: int, momentum: float,
                       lr_alpha: float, grow: float, b0: int, max_batch: int,
                       device):
    """One local step for all N clients, *no* communication.

    Returned fn: (params, mom, t, key, data, center, eta) -> t + 1, with
    params and mom updated in place.
    """
    batch_weights = make_batch_weights(batch, grow, b0, max_batch, device)

    def step_fn(params, mom, t, key, data, center, eta):
        client_sgd_step(loss_fn, batch, momentum, params, mom, data, key,
                        center, batch_weights(t), _eta_t(eta, lr_alpha, t))
        return t + 1.0

    return step_fn


def _copy_broadcast_(dst, src):
    """dst (N, …) leaves ← src (…) leaves, each client's replica a copy."""
    flat_d, treedef = tree_flatten(dst)
    for d, s in zip(flat_d, treedef.flatten_up_to(src)):
        d.copy_(s.unsqueeze(0).expand_as(d))


def make_round_fn(loss_fn, *, k: int, batch: int, momentum: float,
                  lr_alpha: float, grow: float, b0: int, max_batch: int,
                  device, reducer=None):
    """One communication round = k local steps + 1 reduced average.

    Returned fn: (carry, key_r, data, center, eta) -> carry where
    carry = (params_stacked, momentum_stacked, t_global, comm_state) and
    the stacked trees are updated in place. ``reducer`` (default
    DenseMean) is a ``comm.Reducer`` or an ``engine.Topology``; its state
    rides in the carry. Momentum is always dense-averaged.
    """
    reducer = reducer if reducer is not None else get_reducer(None)
    step = make_local_step_fn(loss_fn, batch=batch, momentum=momentum,
                              lr_alpha=lr_alpha, grow=grow, b0=b0,
                              max_batch=max_batch, device=device)

    def round_fn(carry, key_r, data, center, eta):
        params, mom, t, comm = carry
        for key_t in key_r.split(k):
            t = step(params, mom, t, key_t, data, center, eta)
        consensus, comm = reducer.reduce(params, comm,
                                         key_r.fold_in(_COMM_SALT))
        # the consensus rebroadcast is a real copy into every replica,
        # which the next round's kernel launches update in place
        _copy_broadcast_(params, consensus)
        _copy_broadcast_(mom, tree_mean_leading(mom))
        return params, mom, t, comm

    return round_fn


def replica_divergence(stacked):
    """Relative replica spread: Σ_leaves mean_i ‖x_i − x̄‖² / (‖x̄‖² + ε)."""
    mean = tree_mean_leading(stacked)
    num = 0.0
    den = 0.0
    for x, m in zip(tree_leaves(stacked), tree_leaves(mean)):
        d = x.to(torch.float32) - m[None].to(torch.float32)
        num += torch.mean(torch.sum(d * d, dim=tuple(range(1, d.dim()))))
        den += torch.sum(m.to(torch.float32) ** 2)
    return num / (den + 1e-12)


class VmapSimulatorBackend:
    """Engine backend: N client replicas stacked on one device.

    Runs each stage in chunks of ``chunk_rounds`` communication rounds,
    evaluating the averaged model after every round on the device and
    reading the chunk's values back once; keeps the (round, objective)
    history and the target/max_rounds early exit.
    """

    def __init__(self, loss_fn: Callable, init_params, client_data,
                 eval_fn: Callable, *, device=None, eval_every: int = 1,
                 max_rounds: Optional[int] = None,
                 target: Optional[float] = None, lr_alpha: float = 0.0,
                 chunk_rounds: int = 32, rng=None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.init_params = tree_to(init_params, self.device)
        self.client_data = tree_to(client_data, self.device)
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.max_rounds = max_rounds
        self.target = target
        self.lr_alpha = lr_alpha
        self.chunk_rounds = chunk_rounds
        self._rng = rng

    def setup(self, engine: Engine):
        cfg = engine.cfg
        algo = engine.algorithm
        N = tree_leaves(self.client_data)[0].shape[0]
        self.use_prox = algo.uses_center(cfg)
        ploss = prox_loss(self.loss_fn, algo.gamma_inv(cfg))
        self.wloss = algo.local_update.make_loss(ploss)
        self.batch = algo.local_update.round_batch(cfg)
        self.grow = algo.local_update.growth(cfg)

        self.params = tree_broadcast_leading(self.init_params, N)
        self.mom = tree_zeros_like(self.params)
        self.comm_state = engine.topology.init_state(self.params)
        self.rng = (self._rng if self._rng is not None
                    else TorchKey(cfg.seed, self.device))
        self.history: List[Record] = [
            Record(0, 0, float(self.eval_fn(self.init_params)))]
        self.rounds_done = 0
        self.iters_done = 0
        self.t_global = 0.0
        self._round_cache = {}
        engine.set_cost_basis(self.init_params, N)

    def _round_fn(self, engine: Engine, k: int, b: int):
        key = (k, b)
        if key not in self._round_cache:
            cfg = engine.cfg
            self._round_cache[key] = make_round_fn(
                self.wloss, k=k, batch=b, momentum=cfg.momentum,
                lr_alpha=self.lr_alpha, grow=self.grow,
                b0=cfg.batch_per_client, max_batch=cfg.max_batch,
                device=self.device, reducer=engine.topology)
        return self._round_cache[key]

    def run_stage(self, stage, engine: Engine) -> StageStatus:
        policy = engine.algorithm.sync_policy
        if getattr(policy, "asynchronous", False):
            raise ValueError(
                "asynchronous policies (barrier-free rounds) need the "
                "event-driven backend, which the port does not have yet")
        if getattr(policy, "adaptive", False):
            raise NotImplementedError(
                "the divergence-triggered (adaptive) period comes with a "
                "later slice of the port")
        k = stage.k
        round_fn = self._round_fn(engine, k, self.batch)
        # Non-prox algorithms have no center (None, an empty tree).
        center = tree_mean_leading(self.params) if self.use_prox else None

        status = StageStatus()
        n_rounds = -(-stage.T // k)  # ceil
        carry = (self.params, self.mom, self.t_global, self.comm_state)
        done_in_stage = 0
        while done_in_stage < n_rounds:
            n = min(self.chunk_rounds, n_rounds - done_in_stage)
            self.rng, sub = self.rng.split(2)
            # one wall span per chunk of n rounds (k local steps + reduce
            # each); the device is read once, at its end
            with engine.tracer.span("local_steps", cat=CAT_COMPUTE,
                                    track="simulator",
                                    attrs={"s": stage.s, "rounds": n,
                                           "k": k, "eta": stage.eta}):
                vals = []
                for key_r in sub.split(n):
                    carry = round_fn(carry, key_r, self.client_data,
                                     center, stage.eta)
                    vals.append(self.eval_fn(tree_mean_leading(carry[0])))
                vals = torch.stack(vals).tolist()
            hit = None
            for j, v in enumerate(vals):
                rd = self.rounds_done + j + 1
                at_target = self.target is not None and v <= self.target
                if rd % self.eval_every == 0 \
                        or (done_in_stage + j + 1) == n_rounds \
                        or (at_target and hit is None):
                    self.history.append(
                        Record(rd, self.iters_done + (j + 1) * k, v))
                if at_target and hit is None:
                    hit = rd
            self.rounds_done += n
            self.iters_done += n * k
            done_in_stage += n
            status.rounds += n
            status.iters += n * k
            if hit is not None:
                status.stop = True
                break
            if self.max_rounds is not None \
                    and self.rounds_done >= self.max_rounds:
                status.stop = True
                break
        self.params, self.mom, self.t_global, self.comm_state = carry
        engine.metrics.gauge(
            "train.stage_objective", unit="objective",
            help="eval_fn(averaged params) at stage end").set(
                self.history[-1].value, stage=stage.s)
        return status

    def finish(self, engine: Engine) -> List[Record]:
        return self.history


def run(loss_fn: Callable, init_params, client_data, cfg: TrainConfig,
        eval_fn: Callable, *, device=None, eval_every: int = 1,
        max_rounds: Optional[int] = None, target: Optional[float] = None,
        lr_alpha: float = 0.0, chunk_rounds: int = 32, reducer=None,
        topology=None, tracer=None, rng=None) -> List[Record]:
    """Run ``cfg.algo`` and return the (comm-round, objective) trace.

    loss_fn(params, batch) -> scalar tensor (per-client minibatch loss).
    init_params: one replica's parameter tree of tensors.
    client_data: tree of tensors with leading client axis N on every leaf.
    eval_fn(params) -> scalar tensor on the *averaged* model.
    ``device`` — where the run happens; None means CUDA, and the call
    raises when CUDA is absent (pass ``device="cpu"`` for the plain
    PyTorch versions of the kernels).
    ``reducer`` / ``topology`` — a comm.Reducer / engine.Topology or spec
    string; default ``cfg.reducer`` on ``cfg.topology``.
    ``tracer`` — an ``obs.Tracer`` (None = disabled).
    ``rng`` — the root random key (default ``TorchKey(cfg.seed, device)``).
    """
    engine = Engine(cfg.algo, cfg, topology=topology, reducer=reducer,
                    tracer=tracer)
    backend = VmapSimulatorBackend(
        loss_fn, init_params, client_data, eval_fn, device=device,
        eval_every=eval_every, max_rounds=max_rounds, target=target,
        lr_alpha=lr_alpha, chunk_rounds=chunk_rounds, rng=rng)
    return engine.run(backend)


def rounds_to_target(history: List[Record], target: float) -> Optional[int]:
    for rec in history:
        if rec.value <= target:
            return rec.round
    return None
