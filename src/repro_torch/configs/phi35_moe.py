"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]

32L d_model=4096 32H (GQA kv=8) d_ff(expert)=6400 vocab=32064, MoE 16e top-2.
All layers are MoE (no shared experts, no dense layers).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
    ),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=6400, aux_coef=0.01),
    block_pattern=("G",),
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="phi3.5-moe-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=64),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=128, aux_coef=0.01, capacity_factor=64.0),
)
