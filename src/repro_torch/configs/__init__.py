"""Architecture registry of the port: ``get_config(arch_id)``."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (  # noqa: F401
    MIGRATION_BW_DEFAULT,
    ModelConfig,
    MoEConfig,
    PlacementConfig,
    ReaLBConfig,
    ReplicationConfig,
    reduced,
)

_ARCH_MODULES: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
