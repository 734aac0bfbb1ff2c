"""Architecture registry: ``--arch <id>`` resolution for the port.

Holds only the architectures the port serves so far; each registers a FULL
config and a reduced SMOKE config of the same structure."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama_moe_4_16": "llama_moe_4_16",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "xlstm-1.3b": "xlstm_1_3b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
