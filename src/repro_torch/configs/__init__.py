"""Assigned-architecture registry: ``get(name)`` -> full ModelConfig,
``get_smoke(name)`` -> reduced same-family config for CPU smoke tests;
port of ``repro/configs/__init__.py``.

Every architecture of the reference has its configuration module here,
field for field; an unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "arctic_480b",
    "olmoe_1b_7b",
    "rwkv6_1p6b",
    "qwen3_14b",
    "command_r_35b",
    "phi3_medium_14b",
    "qwen3_8b",
    "seamless_m4t_large_v2",
    "qwen2_vl_72b",
    "recurrentgemma_9b",
)

# external ids (with dashes) -> module names
ALIASES = {i.replace("_", "-").replace("-1p6b", "-1.6b"): i for i in ARCH_IDS}


def _module(name: str):
    key = name.replace("-", "_").replace("1.6b", "1p6b").replace(".", "p")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke_config()
