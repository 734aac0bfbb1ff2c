"""Architecture registry: ``--arch <id>`` resolution for the port.

Holds only the architectures the port serves so far; each registers a FULL
config and a reduced SMOKE config of the same structure."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama_moe_4_16": "llama_moe_4_16",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-7b": "qwen2_7b",
    "granite-8b": "granite_8b",
    "gemma3-27b": "gemma3_27b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-base": "whisper_base",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
