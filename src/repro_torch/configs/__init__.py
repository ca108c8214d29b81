"""Architecture registry (port of ``repro/configs``).  ``get_config(arch)``
returns the full ArchConfig; ``get_config(arch, smoke=True)`` the reduced
same-family config the CPU tests use; ``all_configs`` every config of
:data:`ARCH_IDS`.

The paper's four CNN benchmarks (:data:`CNN_IDS`) are here in full: each
returns ``{"layers", "array"}`` as the JAX registry's does.  Every config
of :data:`ARCH_IDS` serves through ``launch/serve.py`` in its ``models/``
form; the transformer lowering also serves stablelm-1.6b and the
whisper-base encoder as mapped matmuls."""
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

CNN_IDS = ("cnn8", "inception", "densenet40", "mobilenet")


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False):
    name = canon(arch)
    if name not in ARCH_IDS + CNN_IDS:
        raise ValueError(f"unknown config {arch!r}; known: "
                         f"{ARCH_IDS + CNN_IDS}")
    mod = importlib.import_module(f"{__name__}.{name}")
    return mod.smoke_config() if smoke else mod.config()


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCH_IDS}
