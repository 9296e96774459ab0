"""Architecture registry of the port: ``get_arch(name)`` / ``get_smoke``.

Each module exports ``ARCH`` (the exact published widths) and ``SMOKE``
(a reduced same-family variant for CPU tests), copied from the JAX
reference's registry. The port carries every config of the
reference: the served cascade's xLSTM and Llama, the dense phi3-mini,
qwen2-72b and granite-34b, the MoE granite-moe and DeepSeek-V3 (MLA,
MTP), the Mamba/attention hybrid Jamba, with its experts or in the
expert-free one-period form of :func:`without_experts`, the image model
``pixtral-12b`` and the encoder-decoder ``whisper-small``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.config import ArchConfig

_MODULES = {
    "whisper-small": "whisper_small",
    "granite-34b": "granite_34b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "pixtral-12b": "pixtral_12b",
    "qwen2-72b": "qwen2_72b",
    "xlstm-125m": "xlstm_125m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
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


def without_experts(cfg: ArchConfig) -> ArchConfig:
    """One period of ``cfg``'s first segment with every MoE FFN made the
    dense FFN of width ``d_ff`` (for Jamba, one expert's hidden width):
    the form in which the hybrid's full width fits one card.
    Only ``dataclasses.replace`` is used, so it applies to the
    reference's config classes too."""
    seg = cfg.segments[0]
    blocks = tuple(dataclasses.replace(b, ffn="dense") if b.ffn == "moe"
                   else b for b in seg.blocks)
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-1p-dense",
        segments=(dataclasses.replace(seg, blocks=blocks, repeat=1),))


def get_smoke(name: str) -> ArchConfig:
    mod = _load(name)
    if name == "llama3.2-1b-sw":
        return mod.SMOKE_SW
    return mod.SMOKE
