"""Config registry: ``get_config("<arch>")`` / ``--arch <id>``."""

from .base import SHAPES, ArchConfig, MoEConfig, ShapeSpec, SSMConfig
from .gemma_7b import ARCH as GEMMA_7B
from .gpt2_medium import ARCH as GPT2_MEDIUM
from .internvl2_1b import ARCH as INTERNVL2_1B
from .mamba2_780m import ARCH as MAMBA2_780M
from .mistral_large_123b import ARCH as MISTRAL_LARGE_123B
from .mixtral_8x22b import ARCH as MIXTRAL_8X22B
from .moonshot_v1_16b_a3b import ARCH as MOONSHOT_V1_16B_A3B
from .qwen1_5_110b import ARCH as QWEN1_5_110B
from .recurrentgemma_9b import ARCH as RECURRENTGEMMA_9B
from .starcoder2_15b import ARCH as STARCODER2_15B
from .whisper_large_v3 import ARCH as WHISPER_LARGE_V3

# The ten assigned architectures (the benchmark grid) + the paper's GPT-2.
ASSIGNED: dict[str, ArchConfig] = {
    a.name: a for a in [
        GEMMA_7B, QWEN1_5_110B, STARCODER2_15B, MISTRAL_LARGE_123B,
        WHISPER_LARGE_V3, RECURRENTGEMMA_9B, INTERNVL2_1B,
        MOONSHOT_V1_16B_A3B, MIXTRAL_8X22B, MAMBA2_780M,
    ]
}

CONFIGS: dict[str, ArchConfig] = dict(ASSIGNED)
CONFIGS[GPT2_MEDIUM.name] = GPT2_MEDIUM


def get_config(name: str) -> ArchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


def list_configs() -> list[str]:
    return sorted(CONFIGS)


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeSpec", "SHAPES",
           "ASSIGNED", "CONFIGS", "get_config", "list_configs"]
