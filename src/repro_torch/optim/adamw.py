"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule.

Mirror of ``repro.optim.adamw``: the same state tree ``{"m", "v",
"step"}`` (f32 moments shaped like the parameters, an int32 step) and
the same update, term for term — the global gradient norm over every
leaf, the clip scale, the bias corrections, and the decay applied to the
f32 copy of the parameter beside the Adam step.  It is not
``torch.optim.AdamW``, which decays the parameter before the step and
adds epsilon elsewhere.

Unlike the reference, which returns new arrays, :meth:`AdamW.update`
writes the new parameters and moments into the tensors it is given and
returns the same trees: one card holds one copy of them.  The step and
the schedule are host scalars (the step lives on the CPU), computed in
float32 as the reference computes them.

On a ``DeviceMesh`` the parameters, gradients and moments are DTensors
of the same placements (:meth:`AdamW.state_axes`: the moments take the
parameters' logical axes, a ZeRO-style sharded state), and the update
runs on each rank's local blocks.  :func:`global_norm` sums every
distinct block once over the mesh, so the norm and the clip scale are
the global ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """``lr(step)`` -> a Python float, computed in float32 with the
    reference's operations."""
    def lr(step) -> float:
        step = _f32(float(step))
        if step < warmup_steps:
            return float(base_lr * step / max(warmup_steps, 1))
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return float(base_lr * cos)
    return lr


def tree_leaves(tree) -> List[Any]:
    """Leaves of nested dicts / lists, dict keys in sorted order (the
    order ``jax.tree.leaves`` gives the reference's trees)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same place)`` over the leaves of
    ``tree``, keeping its nesting (``rest`` may hold anything at a leaf
    of ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def _local(t):
    """A DTensor's local block (a view: writes reach the DTensor); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) of every leaf, in f32, on the leaves' device.
    DTensor leaves: each rank sums its blocks' squares, counted only by
    the rank at coordinate 0 of the mesh axes the leaf is whole on (so
    each block once), and one sum over the mesh gives every rank the
    global norm, a plain tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    leaves = tree_leaves(grads)
    mesh = next((g.device_mesh for g in leaves if isinstance(g, DTensor)),
                None)
    coord = None if mesh is None else mesh.get_coordinate()
    total = None
    for g in leaves:
        sq = torch.sum(torch.square(_local(g).float()))
        if mesh is not None and any(
                isinstance(p, Replicate) and coord[d] != 0
                for d, p in enumerate(g.placements)):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> Dict[str, Any]:
        """f32 zero moments shaped (and, for DTensor parameters, placed)
        like the parameters; the step an int32 on the CPU."""
        def zeros(t):
            return tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), t)
        return {"m": zeros(params), "v": zeros(params),
                "step": torch.zeros((), dtype=torch.int32)}

    def state_axes(self, param_axes) -> Dict[str, Any]:
        """The logical axes of :meth:`init`'s state: the moments'
        are the parameters'; the step has none."""
        return {"m": param_axes, "v": param_axes, "step": ()}

    @torch.no_grad()
    def update(self, grads, state, params
               ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.lr(int(step))
        b1, b2 = self.b1, self.b2
        s32 = _f32(float(step))
        bc1 = float(1 - _f32(b1) ** s32)
        bc2 = float(1 - _f32(b2) ** s32)

        for p, g, m, v in zip(*(map(_local, tree_leaves(t)) for t in (
                params, grads, state["m"], state["v"]))):
            g = g.float() * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
            delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
            p32 = p.float()
            new_p = p32 - delta.add_(p32 * self.weight_decay).mul_(lr)
            p.copy_(new_p)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, {"m": state["m"], "v": state["v"],
                        "step": step}, metrics
