"""Architecture registry of the port: ``get_arch(name)`` / ``get_smoke``.

Each module exports ``ARCH`` (the exact published widths) and ``SMOKE``
(a reduced same-family variant for CPU tests), copied from the JAX
reference's registry. This slice carries the two families of the served
cascade; the other families arrive with their slices.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ArchConfig

_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "llama3.2-1b": "llama3_2_1b",
    "llama3.2-1b-sw": "llama3_2_1b",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "llama3.2-1b-sw"]


def _load(name: str):
    try:
        mod = _MODULES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}") \
            from None
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchConfig:
    mod = _load(name)
    if name == "llama3.2-1b-sw":
        return mod.ARCH_SW
    return mod.ARCH


def get_smoke(name: str) -> ArchConfig:
    mod = _load(name)
    if name == "llama3.2-1b-sw":
        return mod.SMOKE_SW
    return mod.SMOKE
