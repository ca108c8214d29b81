"""Architecture registry (port of ``repro/configs``).  ``get_config(arch)``
returns the full ArchConfig; ``get_config(arch, smoke=True)`` the reduced
same-family config the CPU tests use.

Only the configs a ported path serves have their module here
(:data:`PORTED`): the transformer lowering serves stablelm-1.6b and the
whisper-base encoder, and ``launch/serve.py`` serves mamba2-130m.  The
others of :data:`ARCH_IDS` raise until a slice needs them (ROADMAP.md
queue 1)."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "internvl2_26b",
    "deepseek_67b",
    "mistral_large_123b",
    "stablelm_1_6b",
    "qwen1_5_32b",
    "whisper_base",
    "recurrentgemma_9b",
    "deepseek_v2_lite_16b",
    "mixtral_8x7b",
    "mamba2_130m",
)

#: The configs of ARCH_IDS this package has.
PORTED = ("stablelm_1_6b", "whisper_base", "mamba2_130m")


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False):
    name = canon(arch)
    if name not in PORTED:
        known = "known" if name in ARCH_IDS else "unknown"
        raise ValueError(f"config {arch!r} ({known}) is not ported yet; "
                         f"ported: {PORTED}")
    mod = importlib.import_module(f"{__name__}.{name}")
    return mod.smoke_config() if smoke else mod.config()
