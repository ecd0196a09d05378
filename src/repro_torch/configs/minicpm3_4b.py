"""minicpm3-4b [dense] — MLA attention. [hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448, Multi-head Latent
Attention with q_lora=768 / kv_lora=256 (per the MiniCPM3 model card).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

FULL = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    attention=AttentionConfig(
        kind="mla",
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        rope_theta=10000.0,
    ),
    block_pattern=("G",),
)

SMOKE = FULL.replace(
    name="minicpm3-4b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(
        kind="mla",
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        q_lora_rank=96,
        kv_lora_rank=64,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
)
