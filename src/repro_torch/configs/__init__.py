"""Architecture registry: ``--arch <id>`` resolves here.

The ids are the reference's (``repro.configs``).  The port has the
dense family's configs; an id of a family it has not ported yet raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings it.
"""

from __future__ import annotations

from importlib import import_module

from .base import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-20b": "granite_20b",
    "gemma3-27b": "gemma3_27b",
    "phi3-mini-3.8b": "phi3_mini",
}

#: ids of the reference whose family is not ported yet -> that family
UNPORTED = {
    "dbrx-132b": "moe",
    "granite-moe-1b-a400m": "moe",
    "llava-next-mistral-7b": "vlm",
    "mamba2-780m": "ssm",
    "hymba-1.5b": "hybrid",
    "whisper-small": "audio",
}

#: every id of the reference
ARCH_IDS = (*_MODULES, *UNPORTED)


def unported_family(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family!r} family is not ported yet (ROADMAP.md Queue 1 "
        "item 4.2); the port runs dense models")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in UNPORTED:
        raise unported_family(UNPORTED[arch_id])
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return import_module(f"{__name__}.{_MODULES[arch_id]}").CONFIG
