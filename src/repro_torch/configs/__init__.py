"""Architecture registry of the port: ``get_config(arch_id)``, and the
dry run's cells (``get_shape``, ``shape_supported``, ``all_cells``), as
the reference's ``repro.configs``."""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    MIGRATION_BW_DEFAULT,
    MULTI_POD_MESH,
    PREFILL_32K,
    SINGLE_POD_MESH,
    TRAIN_4K,
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PlacementConfig,
    ReaLBConfig,
    ReplicationConfig,
    ShapeConfig,
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


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, by the reference's rule."""
    if shape.name == "long_500k" and cfg.full_attention_only:
        return False, ("skip: long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """(arch, shape, supported, reason) of all 40 cells."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            ok, why = shape_supported(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out
