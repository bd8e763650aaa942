"""Architecture registry (port of ``repro.configs.registry``): ``--arch
<id>`` resolution for every launcher."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCH_IDS: List[str] = [
    "deepseek-v2-236b",
    "deepseek-v2-lite-16b",
    "minicpm3-4b",
    "deepseek-7b",
    "mistral-large-123b",
    "chatglm3-6b",
    "mamba2-130m",
    "llava-next-34b",
    "zamba2-2.7b",
    "hubert-xlarge",
    "paper-mpfp-100m",
]

_MODULES: Dict[str, str] = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "minicpm3-4b": "minicpm3_4b",
    "deepseek-7b": "deepseek_7b",
    "mistral-large-123b": "mistral_large_123b",
    "chatglm3-6b": "chatglm3_6b",
    "mamba2-130m": "mamba2_130m",
    "llava-next-34b": "llava_next_34b",
    "zamba2-2.7b": "zamba2_2_7b",
    "hubert-xlarge": "hubert_xlarge",
    "paper-mpfp-100m": "paper_mpfp",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def assigned_archs() -> List[str]:
    """The 10 assigned architectures (excludes the paper's own vehicle)."""
    return [a for a in ARCH_IDS if a != "paper-mpfp-100m"]
