"""Architecture and run configuration dataclasses.

The port's copy of the JAX package's ``configs/base.py``: the architecture
schema (``AttentionConfig`` … ``ArchConfig``, ``ShapeConfig``/``SHAPES``)
and ``TrainConfig``, with the same fields and defaults, so one config value
means the same model and run in both packages. Which archs the port's
models can build is decided in ``configs/__init__.py``. ``topology``
accepts the JAX package's specs: "star", "streaming" and the two-level
"hier" / "streaming-hier" (``n_pods``, ``inter_reducer``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"  # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    qk_norm: bool = False            # qwen3
    logit_softcap: Optional[float] = None  # gemma2 (50.0)
    rope_theta: float = 10000.0
    # Sliding-window: applied to layers marked "L" in ArchConfig.block_pattern.
    window: Optional[int] = None
    # MLA (deepseek-v2 / minicpm3)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0        # deepseek-v2: 2 shared experts
    d_expert: int = 1536     # per-expert hidden dim
    aux_coef: float = 0.01   # load-balance auxiliary loss weight
    capacity_factor: float = 1.25  # expert buffer slack; large => dropless
    # dense (non-MoE) first layers, e.g. deepseek-v2 replaces layer 0 MoE w/ dense MLP
    n_dense_layers: int = 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    # RecurrentGemma recurrent block (arXiv:2402.19427)
    lru_width: Optional[int] = None  # default: d_model
    d_conv: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str = "arch"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""       # citation (paper / model card)
    n_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32000
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # Per-layer block kinds, cycled over n_layers:
    #   "G" global attention, "L" sliding-window attention,
    #   "M" mamba2/SSD block, "R" RG-LRU recurrent block.
    block_pattern: Tuple[str, ...] = ("G",)
    tie_embeddings: bool = True
    final_softcap: Optional[float] = None  # gemma2 (30.0)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # int8 symmetric per-(position, head) KV-cache quantization (decode paths)
    kv_quant: bool = False
    # Megatron-SP-style sequence parallelism: residual-stream activations are
    # sharded over `model` on the sequence dim between blocks, turning each
    # activation all-reduce into reduce-scatter + all-gather (≈½ the bytes).
    seq_parallel: bool = False
    # Modality frontend stub: None | "vision" | "audio". When set, the model
    # additionally consumes precomputed frame/patch embeddings (stub carve-out).
    frontend: Optional[str] = None
    n_frontend_tokens: int = 256   # patches / audio frames prepended to the text tokens
    frontend_dim: int = 1024       # raw embedding dim before the projector

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand block_pattern cyclically to n_layers entries."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}




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
    # ``reducer`` runs intra-pod over the reference's ICI link preset,
    # ``inter_reducer`` inter-pod over the comm_latency_s/comm_bandwidth_gbps
    # WAN link. The vmapped simulator and the event runtime reduce through
    # engine.Hierarchical. n_pods=1 degenerates to the flat star round
    # bit-exactly (no inter-pod link exists).
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
