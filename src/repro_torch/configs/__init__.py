"""Architecture registry of the port: ``get_config(arch_id)``."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (  # noqa: F401
    MIGRATION_BW_DEFAULT,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PlacementConfig,
    ReaLBConfig,
    ReplicationConfig,
    SSMConfig,
    TrainConfig,
    reduced,
)

_ARCH_MODULES: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-large-v3": "whisper_large_v3",
    "gemma-7b": "gemma_7b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen1.5-0.5b": "qwen15_05b",
    "command-r-35b": "command_r_35b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
