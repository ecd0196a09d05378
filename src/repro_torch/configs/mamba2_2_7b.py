"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128, expand=2 (d_inner=5120),
head_dim=64 → 80 SSD heads, one B/C group, chunk 256. Every prefill's SSD
scan runs in the Hopper kernel ``kernels/csrc/ssd.cu``.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

FULL = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50280,
    attention=None,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=256),
    block_pattern=("M",),
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="mamba2-2.7b-smoke",
    n_layers=2,
    d_model=256,
    d_ff=0,
    vocab_size=512,
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=64),
)
