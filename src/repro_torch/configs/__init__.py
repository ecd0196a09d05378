"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each module exposes ``FULL`` (the published config) and ``SMOKE`` (a
reduced variant of the same family), copied from the JAX package. Only
archs whose layer kinds the port's ``models/transformer.py`` builds are
served; every other name the JAX package knows raises and names the
ROADMAP item it waits for.
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
from repro_torch.configs import gemma2_27b, qwen3_14b

ARCHS = {
    "gemma2-27b": gemma2_27b,
    "qwen3-14b": qwen3_14b,
}

# archs of the JAX package the port cannot build yet -> what they wait for
WAITING = {
    "minicpm3-4b": "MLA attention (ROADMAP queue 1: MLA)",
    "deepseek-v2-236b": "MLA attention and MoE (ROADMAP queue 1: MLA, MoE)",
    "phi3.5-moe-42b-a6.6b": "MoE layers (ROADMAP queue 1: MoE)",
    "musicgen-medium": "frontend archs (ROADMAP queue 1: frontend archs)",
    "internvl2-2b": "frontend archs (ROADMAP queue 1: frontend archs)",
    "gemma3-12b": "its config module; its GQA layers are ported (ROADMAP "
                  "queue 1: more archs on the ported layers)",
    "recurrentgemma-2b": "RG-LRU layers (ROADMAP queue 1: RG-LRU)",
    "mamba2-2.7b": "the Mamba2 slice with the ssd kernel (ROADMAP queue 1)",
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
    if name in WAITING:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it waits for {WAITING[name]}")
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
    "WAITING",
    "arch_for_shape",
    "get_arch",
]
