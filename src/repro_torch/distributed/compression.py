"""Gradient compression for the DP reduction (distributed-optimization).

Mirror of ``repro.distributed.compression``.  Two schemes, both with
error feedback (the residual is carried in f32 and added back next step,
so compression error doesn't accumulate as bias):

  * int8: per-block symmetric quantisation (scale = max|g|/127), rounded
    half to even (``torch.round``, as ``jnp.round``).
  * top-k: keep the k largest-|g| entries per tensor (values + indices).
    ``torch.topk`` and ``jax.lax.top_k`` may pick different entries among
    equal magnitudes at the k-th place; on tie-free data they agree.

The hook applies compress→decompress to the *accumulated* gradient
before the optimizer: on a fleet the compressed representation is what
crosses the wire between data-parallel groups; on one card it
reproduces the numerics.

A model's layers are stacked along a leading axis in the reference, and
each of its leaves (one parameter of every layer) is one flattened
tensor: its int8 blocks of 4,096 run across the layers and its top-k
picks among all of them.  The port keeps a list of per-layer dicts (a
model's ``layers``, ``enc_layers``, ``dec_layers``).  With
``stack_layers=True`` (for a model's gradient tree) the transform
stacks a list of dicts' matching leaves, compresses the stack, and
hands each layer its part: the reference's numbers on its stacked tree.
Without, a list is compressed leaf by leaf, as the reference compresses
a tree that holds a list.

On a ``DeviceMesh`` (DTensor gradients and residuals, as
``make_train_step(mesh=)`` hands them over) the reference quantises
blocks of the *global* flattened tensor and keeps the global top-k
under pjit.  So each leaf is gathered whole, compressed as on one card,
and each rank keeps its block of the result and of the residual: the
same numbers as the reference's on any mesh, for one all-gather a leaf.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..optim.adamw import tree_leaves, tree_map
from ..sharding.axes import NamedSharding


def int8_compress_decompress(g: torch.Tensor, block: int = 4096):
    """Quantise to int8 per block, return (dequantised, residual)."""
    flat = g.reshape(-1).float()
    pad = (-flat.shape[0]) % block
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[: flat.shape[0]]
    deq = deq.reshape(g.shape)
    return deq, g.float() - deq


def topk_compress_decompress(g: torch.Tensor, frac: float = 0.05):
    """Keep the top-|frac| entries; everything else becomes residual."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    _vals, idx = torch.topk(flat.abs(), k)
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    return kept.reshape(g.shape), (flat - kept).reshape(g.shape)


def _rebuild(template, values):
    """``template``'s nesting with its leaves, in ``tree_leaves`` order
    (dict keys sorted), taken from the iterator ``values``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values) for v in template)
    return next(values)


def make_compressed_grad_transform(
    scheme: str = "int8", frac: float = 0.05, stack_layers: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns (init_residuals, transform(grads, residuals) ->
    (compressed_grads, new_residuals)) with error feedback;
    ``stack_layers``: a list of dicts is a model's layers, compressed as
    the reference's stacked leaves (see the module's docstring)."""

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def compress(gg):
        if scheme == "int8":
            return int8_compress_decompress(gg)
        if scheme == "topk":
            return topk_compress_decompress(gg, frac)
        raise ValueError(scheme)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def back(t, like):
        if not isinstance(like, DTensor):
            return t
        return NamedSharding(like.device_mesh, like.placements).place(t)

    def stack(gs, rs):
        """One leaf of every layer of a stack, compressed as the
        reference's stacked leaf: -> (outputs, residuals) per layer."""
        gg = torch.stack([whole(g).float() + whole(r)
                          for g, r in zip(gs, rs)])
        out, res = compress(gg)
        return ([back(t, g) for t, g in zip(out, gs)],
                [back(t, g) for t, g in zip(res, gs)])

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], r[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if stack_layers and isinstance(g, (list, tuple)) and g \
                and isinstance(g[0], dict):
            per = [stack(gs, rs) for gs, rs in zip(
                zip(*map(tree_leaves, g)), zip(*map(tree_leaves, r)))]
            outs = [_rebuild(layer, iter([p[0][i] for p in per]))
                    for i, layer in enumerate(g)]
            ress = [_rebuild(layer, iter([p[1][i] for p in per]))
                    for i, layer in enumerate(g)]
            return type(g)(outs), type(g)(ress)
        if isinstance(g, (list, tuple)):
            pairs = [walk(a, b) for a, b in zip(g, r)]
            return (type(g)(p[0] for p in pairs),
                    type(g)(p[1] for p in pairs))
        if g is None:
            return None, None
        out, res = compress(whole(g).float() + whole(r))
        return back(out, g), back(res, g)

    def transform(grads, residuals):
        return walk(grads, residuals)

    return init, transform

