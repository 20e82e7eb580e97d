"""Public wrappers for the port's kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel (built on first
use) or raises; a CPU tensor runs the plain PyTorch version in
:mod:`.ref`.  ``impl="ref"`` runs the plain version on any device — it
exists so that tests and ``chip_smoke.py`` can hold a kernel against its
plain version on the card.  There is no environment default and no
fallback: a CUDA tensor never silently takes the plain path.

Each kernel counts its launches (:func:`launch_counts`,
:func:`reset_launch_counts`); calls of the plain version count nothing.
A kernel with two routes (``flash_attention``: bf16 on the tensor cores,
f32 on the CUDA cores) counts both under its name, one launch of the
fused ``bucket_insert_pass`` (either route) counts under both bucket
kernels, one of ``lsh_hash_resolve`` under ``lsh_hash``, and
:func:`entry_launch_counts` says which C entry point ran.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from . import bucket_ops as _bo
from . import flash_attention as _fa
from . import lsh_hash as _lh
from . import pairwise_dist as _pd
from . import ref as _ref

#: the kernels ops dispatches to the card, each a ``<name>_launch`` C
#: entry point in ``csrc/*.cu`` (``flash_attention`` has a second one,
#: ``flash_attention_sm90_launch``, for bf16; ``lsh_hash`` another,
#: ``lsh_hash_resolve_launch``, for the engine's hash pass; the two bucket
#: kernels share ``bucket_insert_pass_launch`` and its masked route,
#: ``bucket_insert_pass_masked_launch``)
KERNELS = _build.KERNELS


def _on_card(t: torch.Tensor, impl: Optional[str]) -> bool:
    if impl not in (None, "ref"):
        raise ValueError(f"impl must be None or 'ref', got {impl!r}")
    return impl is None and t.device.type == "cuda"


def lsh_hash(x, eta, mixers, *, inv_cell: float, impl: Optional[str] = None):
    if _on_card(x, impl):
        return _lh.lsh_hash(x, eta, mixers, inv_cell=inv_cell)
    return _ref.lsh_hash(x, eta, mixers, inv_cell)


def lsh_hash_resolve(x, eta, mixers, *, inv_cell: float, directory,
                     updates, out=None, impl: Optional[str] = None):
    """The engine's hash pass: apply ``updates`` (u, 4) ``[key a, key b,
    table, slot]`` (slot -1: erase) to ``directory`` (cap, 4) IN PLACE,
    then return [keys (n, t, 2) | slots (n, t)] (3 n t,) int32, a slot -1
    where the directory holds no such key; written into ``out`` when
    given.  One launch on the card, counted under ``lsh_hash``."""
    if _on_card(x, impl):
        return _lh.lsh_hash_resolve(x, eta, mixers, inv_cell=inv_cell,
                                    directory=directory, updates=updates,
                                    out=out)
    return _ref.lsh_hash_resolve(x, eta, mixers, inv_cell, directory,
                                 updates, out)


def slot_counts(slots, *, n_slots: int, impl: Optional[str] = None):
    if _on_card(slots, impl):
        return _bo.slot_counts(slots, n_slots=n_slots)
    return _ref.slot_counts(slots, n_slots)


def bucket_core_stats(slots, sizes, *, k: int, impl: Optional[str] = None):
    if _on_card(slots, impl):
        return _bo.bucket_core_stats(slots, sizes, k=k)
    return _ref.bucket_core_stats(slots, sizes, k)


def bucket_insert_pass(slots, sizes, *, k: int, out=None, core_sizes=None,
                       row_mask=None, impl: Optional[str] = None):
    """An insert batch's stats: ``sizes`` (nb,) += the histogram of
    ``slots`` (n, t) IN PLACE; returns [new sizes | support] (nb + n,),
    written into ``out`` when given.  With ``core_sizes`` (nb,) and
    ``row_mask`` (n,), the masked route: ``core_sizes`` += the histogram
    of the masked rows IN PLACE too, the support runs on it, and the
    result is [new sizes | new core sizes | support] (2 nb + n,).  One
    launch of both bucket kernels on the card, counted under each."""
    if _on_card(slots, impl):
        return _bo.bucket_insert_pass(slots, sizes, k=k, out=out,
                                      core_sizes=core_sizes,
                                      row_mask=row_mask)
    return _ref.bucket_insert_pass(slots, sizes, k, out, core_sizes,
                                   row_mask)


def eps_neighbor_counts(x, *, eps: float, impl: Optional[str] = None):
    if _on_card(x, impl):
        return _pd.eps_neighbor_counts(x, eps=eps)
    return _ref.eps_neighbor_counts(x, eps)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, scale: Optional[float] = None,
              impl: Optional[str] = None):
    """GQA attention, q (b, hq, sq, dh), k and v (b, hkv, skv, dh)."""
    if _on_card(q, impl):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    return _ref.attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, scale=scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_build.LAUNCHES)


def entry_launch_counts() -> Dict[str, int]:
    """Launches per C entry point since the last
    :func:`reset_launch_counts`: ``flash_attention_sm90`` is the bf16
    tensor-core route, ``flash_attention`` the f32 one;
    ``bucket_insert_pass`` is the fused route of ``slot_counts`` and
    ``bucket_core_stats``, which also have standalone entries, and
    ``bucket_insert_pass_masked`` its masked two-table route;
    ``lsh_hash_resolve`` is ``lsh_hash`` with the directory probes."""
    return dict(_build.ENTRY_LAUNCHES)


def reset_launch_counts() -> None:
    _build.reset_launches()


def ensure_built() -> float:
    """Build (or reuse) and load the kernel library; returns the build's
    wall seconds, 0.0 when an existing library was reused.  Raises when
    it cannot be built."""
    _build.load()
    return _build.build_seconds
