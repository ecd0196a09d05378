"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6. [arXiv:2405.04434]

60L d_model=5120 128H (GQA kv=128) d_ff(expert)=1536 vocab=102400, MoE 160e top-6.
The first layer is a dense SwiGLU MLP (d_ff=12288) per the DeepSeek-V2 paper;
``ArchConfig.d_ff`` holds the dense-layer dim, ``moe.d_expert`` the per-expert dim
(=1536 as in the assignment line).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

FULL = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    d_ff=12288,
    vocab_size=102400,
    attention=AttentionConfig(
        kind="mla",
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10000.0,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        n_shared=2,
        d_expert=1536,
        aux_coef=0.003,
        n_dense_layers=1,
    ),
    block_pattern=("G",),
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="deepseek-v2-236b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(
        kind="mla",
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        q_lora_rank=128,
        kv_lora_rank=64,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    moe=MoEConfig(
        n_experts=4, top_k=2, n_shared=1, d_expert=128, aux_coef=0.003, n_dense_layers=1, capacity_factor=64.0
    ),
)
