"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (the exact assigned configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).  The
port holds all ten architectures of ``repro.configs``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("granite_3_2b", "mamba2_780m", "minitron_4b", "olmoe_1b_7b",
            "seamless_m4t_medium", "recurrentgemma_9b", "gemma3_27b",
            "llava_next_34b", "deepseek_67b", "deepseek_v3_671b")

# canonical dashed ids (CLI spelling) -> module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    name = ALIASES.get(arch, arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}: one of {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()

