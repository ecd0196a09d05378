"""musicgen-medium [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284]

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048. The EnCodec
(mel-spectrogram + conv codec) frontend is a stub, as in the JAX package:
a request or a training batch carries precomputed frame embeddings
(batch, n_frames, frontend_dim), projected by ``proj_frontend`` and
prepended to the codebook tokens; the transformer decoder is built in full.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

FULL = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab_size=2048,
    attention=AttentionConfig(
        kind="gqa",
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
    ),
    block_pattern=("G",),
    frontend="audio",
    n_frontend_tokens=256,
    frontend_dim=768,
)

SMOKE = FULL.replace(
    name="musicgen-medium-smoke",
    n_layers=2,
    d_model=256,
    d_ff=512,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=64),
    n_frontend_tokens=16,
    frontend_dim=96,
)
