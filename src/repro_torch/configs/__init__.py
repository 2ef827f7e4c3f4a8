"""Assigned architecture configs (exact specs from the public pool) plus the
GBDT configs for the paper's own benchmark datasets.

get_arch(name) -> ArchConfig;  ARCHS lists all ten assigned ids.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "phi-3-vision-4.2b",
    "zamba2-7b",
    "mamba2-2.7b",
    "minicpm3-4b",
    "glm4-9b",
    "yi-6b",
    "seamless-m4t-medium",
    "llama4-maverick-400b-a17b",
    "stablelm-12b",
    "llama4-scout-17b-a16e",
]

_MODULES = {
    "phi-3-vision-4.2b": "phi3_vision",
    "zamba2-7b": "zamba2",
    "mamba2-2.7b": "mamba2",
    "minicpm3-4b": "minicpm3",
    "glm4-9b": "glm4",
    "yi-6b": "yi6b",
    "seamless-m4t-medium": "seamless_m4t",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "stablelm-12b": "stablelm12b",
    "llama4-scout-17b-a16e": "llama4_scout",
}


def get_arch(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
