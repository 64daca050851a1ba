"""Architecture registry: one module per assigned architecture, each
exporting CONFIG (the exact published numbers) and REDUCED (same family
traits at smoke-test scale)."""
from __future__ import annotations

import importlib

ARCHS = (
    "llama3_405b",
    "granite_20b",
    "yi_6b",
    "qwen3_1p7b",
    "zamba2_1p2b",
    "qwen2_vl_72b",
    "deepseek_v2_lite_16b",
    "arctic_480b",
    "falcon_mamba_7b",
    "whisper_tiny",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "llama3-405b": "llama3_405b",
    "qwen3-1.7b": "qwen3_1p7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
})


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def get_config(arch: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False):
    return {a: get_config(a, reduced) for a in ARCHS}
