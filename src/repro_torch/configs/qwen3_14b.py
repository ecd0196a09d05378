"""qwen3-14b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

FULL = ArchConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab_size=151936,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        qk_norm=True,
        rope_theta=1000000.0,
    ),
    block_pattern=("G",),
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="qwen3-14b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(
        kind="gqa", n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True
    ),
)
