"""internvl2-2b [vlm] — InternViT + InternLM2. [arXiv:2404.16821]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The InternViT vision
encoder is a stub, as in the JAX package: a request or a training batch
carries precomputed patch embeddings (batch, n_patches, frontend_dim),
which ``proj_frontend`` projects and the transformer prepends to the text
tokens; the projector and the InternLM2-style decoder are built in full.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

FULL = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        rope_theta=1000000.0,
    ),
    block_pattern=("G",),
    frontend="vision",
    n_frontend_tokens=256,
    frontend_dim=1024,
)

SMOKE = FULL.replace(
    name="internvl2-2b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=64),
    n_frontend_tokens=16,
    frontend_dim=96,
)
