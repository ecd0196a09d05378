"""gemma2-27b [dense] — alternating local/global attention, logit softcap. [arXiv:2408.00118]

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, window 4096 on local
layers, attention logit softcap 50.0, final logit softcap 30.0.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

FULL = ArchConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab_size=256000,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        logit_softcap=50.0,
        window=4096,
        rope_theta=10000.0,
    ),
    block_pattern=("L", "G"),
    final_softcap=30.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="gemma2-27b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(
        kind="gqa", n_heads=4, n_kv_heads=2, head_dim=64, logit_softcap=50.0, window=64
    ),
)
