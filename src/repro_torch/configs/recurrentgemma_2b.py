"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 LRU. [arXiv:2402.19427]

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000, pattern
(R, R, L) — two RG-LRU recurrent blocks then one sliding-window (2048)
attention block; 26 layers are 8 groups of (R, R, L) and a tail of R, R.
The recurrent blocks keep a constant-size state (``models/rglru.py``); the
local layers' prefill runs the Hopper flash kernel.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, RGLRUConfig

FULL = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab_size=256000,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        window=2048,
        rope_theta=10000.0,
    ),
    rglru=RGLRUConfig(lru_width=2560, d_conv=4),
    block_pattern=("R", "R", "L"),
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="recurrentgemma-2b-smoke",
    n_layers=3,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(
        kind="gqa", n_heads=4, n_kv_heads=1, head_dim=64, window=64
    ),
    rglru=RGLRUConfig(lru_width=256, d_conv=4),
)
