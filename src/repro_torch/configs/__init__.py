"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

ARCHS = {
    "llama3-8b": "llama3_8b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-67b": "deepseek_67b",
    "command-r-35b": "command_r_35b",
    "zamba2-2.7b": "zamba2_2p7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "grok-1-314b": "grok1_314b",
    "whisper-small": "whisper_small",
    "internvl2-26b": "internvl2_26b",
    "mamba2-2.7b": "mamba2_2p7b",
}


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f".{ARCHS[name]}", __name__)
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
