"""Run configuration — the paper's Alg. 1–3 knobs.

The port's copy of ``TrainConfig`` (the JAX package's ``configs/base.py``
also holds the transformer architecture schemas, which wait for the
transformer slice). Same fields and defaults, so one config value means
the same run in both packages. ``topology`` accepts "star" and
"streaming" here; the hierarchical topology waits for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters for one training run (paper's Alg. 1–3 knobs)."""
    algo: str = "stl_sc"  # sync | lb | crpsgd | local | stl_sc | stl_nc1 | stl_nc2
    eta1: float = 0.1       # initial learning rate η₁
    k1: float = 8.0         # initial communication period k₁
    T1: int = 100           # first-stage length T₁
    n_stages: int = 6       # S
    iid: bool = True        # IID vs Non-IID k-growth rule (2 vs √2)
    gamma_inv: float = 0.0  # 1/γ for the prox term in STL-SGD^nc (Alg. 3); 0 = none
    momentum: float = 0.0
    weight_decay: float = 0.0
    batch_per_client: int = 32
    # baselines
    batch_growth: float = 1.1  # CR-PSGD ρ
    max_batch: int = 512
    seed: int = 0
    # communication round (repro.comm): reducer spec + α–β network model.
    # "dense" is bit-exact Alg. 1; "int8"/"int<b>" = stochastic-rounding
    # quantization (quant_bits wide for "quant"), "topk" = magnitude top-k.
    reducer: str = "dense"
    quant_bits: int = 8          # width for reducer="quant"/"int<b>"
    topk_frac: float = 0.1       # kept fraction for reducer="topk"
    comm_latency_s: float = 5e-3      # α: fixed per-round latency
    comm_bandwidth_gbps: float = 1.0  # β⁻¹: link bandwidth
    # communication topology (repro.engine): "star" is the paper's flat
    # parameter-server setting; "hier" splits clients into n_pods pods —
    # ``reducer`` runs intra-pod over calibrated ICI, ``inter_reducer``
    # inter-pod over the comm_latency_s/comm_bandwidth_gbps WAN link.
    # Honored by both front-ends: the vmapped simulator reduces through
    # engine.Hierarchical, and the StagewiseDriver executes the same
    # two-level round via a local_sgd.build_sync_step(hierarchical=True,
    # n_pods=..., inter_reducer=...) sync step (whose tags must agree with
    # these fields — the driver refuses mismatches so the ledger always
    # prices the round the collectives execute). n_pods=1 degenerates to
    # the flat star round bit-exactly (no inter-pod link exists).
    topology: str = "star"
    n_pods: int = 2
    inter_reducer: str = "int8"
    # discrete-event runtime (repro.runtime): heterogeneous clients + async.
    # async_mode wraps cfg.algo in an AsyncPeriod policy — clients upload
    # after k local steps without barriering and the server merges each
    # message on arrival with weight (1 + staleness)^(-staleness_decay).
    # Heterogeneity knobs feed the event clock: per-local-step compute time,
    # straggler cohort (frac of clients slowed by slowdown×), lognormal
    # per-client compute/network jitter, and per-upload dropout probability.
    async_mode: bool = False
    staleness_decay: float = 0.5
    base_step_time_s: float = 1e-3
    straggler_frac: float = 0.0
    straggler_slowdown: float = 1.0
    compute_jitter: float = 0.0
    dropout_rate: float = 0.0
    # upload schedule (repro.runtime): how a client's round-end message
    # meets the event clock. "blocking" ships one monolithic message after
    # compute_done; "streaming" starts each leaf's upload as soon as its
    # last local step completes (reverse-layer order), overlapping the
    # remaining compute — modeled time only, trajectories are bit-exact
    # across schedules. The execution-side analogue is topology="streaming"
    # (engine.StreamingStar: the pjit driver's per-leaf reduce).
    # "streaming-uplink" restores the uplink-only overlap (blocking WAN hop
    # + monolithic broadcast) — the comparator the full streaming round's
    # downlink/WAN overlap is measured against.
    upload_schedule: str = "blocking"
    # bill the dense server→client broadcast as its own downlink hop
    # (comm.NetworkModel.count_downlink). Off by default (multicast,
    # reducer-independent — see docs/cost_model.md); when on, the blocking
    # schedule ships it monolithically after the merge while the streaming
    # schedule ships leaf l as soon as the server finishes reducing it.
    count_downlink: bool = False
