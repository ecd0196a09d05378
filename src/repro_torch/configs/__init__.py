"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each module exposes ``FULL`` (the published config) and ``SMOKE`` (a
reduced variant of the same family), copied from the JAX package. Every
arch the JAX package knows resolves here.
"""
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    AttentionConfig,
    MoEConfig,
    RGLRUConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
)
from repro_torch.configs import (deepseek_v2_236b, gemma2_27b, gemma3_12b,
                                 internvl2_2b, mamba2_2_7b, minicpm3_4b,
                                 musicgen_medium, phi35_moe, qwen3_14b,
                                 recurrentgemma_2b)

ARCHS = {
    "deepseek-v2-236b": deepseek_v2_236b,
    "gemma2-27b": gemma2_27b,
    "gemma3-12b": gemma3_12b,
    "internvl2-2b": internvl2_2b,
    "mamba2-2.7b": mamba2_2_7b,
    "minicpm3-4b": minicpm3_4b,
    "musicgen-medium": musicgen_medium,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "qwen3-14b": qwen3_14b,
    "recurrentgemma-2b": recurrentgemma_2b,
}

# Archs whose base attention is quadratic-full: long_500k runs their
# sliding-window VARIANT (ring-buffer KV, window=8192).
SWA_VARIANT_FOR_LONG = {
    "minicpm3-4b",
    "musicgen-medium",
    "qwen3-14b",
    "deepseek-v2-236b",
    "internvl2-2b",
    "phi3.5-moe-42b-a6.6b",
}
LONG_WINDOW = 8192


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.FULL


def arch_for_shape(name: str, shape: str, smoke: bool = False) -> ArchConfig:
    """Resolve the arch config to use for a given input shape.

    long_500k on full-attention archs swaps in the sliding-window variant so
    decode state stays O(window) instead of O(seq_len).
    """
    cfg = get_arch(name, smoke=smoke)
    if shape == "long_500k" and name in SWA_VARIANT_FOR_LONG:
        att = cfg.attention
        cfg = cfg.replace(
            name=cfg.name + "+swa",
            attention=AttentionConfig(
                **{**att.__dict__, "window": LONG_WINDOW},
            ),
            block_pattern=("L",),
        )
    return cfg


__all__ = [
    "ARCHS",
    "ArchConfig",
    "AttentionConfig",
    "LONG_WINDOW",
    "MoEConfig",
    "RGLRUConfig",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "SWA_VARIANT_FOR_LONG",
    "TrainConfig",
    "arch_for_shape",
    "get_arch",
]
