"""Architecture registry: ``--arch <id>`` resolves here.

The ids and configs are the reference's (``repro.configs``), one file
each, value for value: the dense, moe, vlm, ssm, hybrid and audio
families.
"""

from __future__ import annotations

from importlib import import_module

from .base import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-20b": "granite_20b",
    "gemma3-27b": "gemma3_27b",
    "phi3-mini-3.8b": "phi3_mini",
    "dbrx-132b": "dbrx_132b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-780m": "mamba2_780m",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-small": "whisper_small",
}

#: every id of the reference
ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return import_module(f"{__name__}.{_MODULES[arch_id]}").CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]


# (arch, shape) grid with documented skips, as the reference's
# (DESIGN.md §Arch-applicability)
LONG_CONTEXT_OK = ("gemma3-27b", "mamba2-780m", "hymba-1.5b")


def cell_supported(arch_id: str, shape_id: str) -> tuple[bool, str]:
    if shape_id == "long_500k" and arch_id not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""
