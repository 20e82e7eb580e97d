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
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..optim.adamw import tree_map


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


def make_compressed_grad_transform(
    scheme: str = "int8", frac: float = 0.05,
) -> Tuple[Callable, Callable]:
    """Returns (init_residuals, transform(grads, residuals) ->
    (compressed_grads, new_residuals)) with error feedback."""

    def init(params):
        return tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)

    def transform(grads, residuals):
        def one(g, r):
            gg = g.float() + r
            if scheme == "int8":
                return int8_compress_decompress(gg)
            if scheme == "topk":
                return topk_compress_decompress(gg, frac)
            raise ValueError(scheme)

        pairs = tree_map(one, grads, residuals)
        return (tree_map(lambda _g, pr: pr[0], grads, pairs),
                tree_map(lambda _g, pr: pr[1], grads, pairs))

    return init, transform

