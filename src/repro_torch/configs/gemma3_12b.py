"""gemma3-12b [dense] — 5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt family]

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144. Layer pattern is five
sliding-window (1024) layers followed by one global layer. Native local
attention qualifies this arch for long_500k decode.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

FULL = ArchConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab_size=262144,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        qk_norm=True,
        window=1024,
        rope_theta=1000000.0,
    ),
    block_pattern=("L", "L", "L", "L", "L", "G"),
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="gemma3-12b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(
        kind="gqa", n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True, window=64
    ),
    block_pattern=("L", "G"),
)
