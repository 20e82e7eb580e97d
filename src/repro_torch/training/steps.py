"""Training step: remat'd forward/backward, microbatch gradient
accumulation, global-norm clipping, AdamW update.

Mirror of ``repro.training.steps`` on one device; the reference's
``mesh`` argument (a step sharded over a ``DeviceMesh``, as the models'
prefill and decode already run) is the next slice's.  One
``loss.backward()`` per microbatch, the gradients summed in the
parameters' dtype (float32, ``param_dtype``) over ``accum`` microbatches
in order, as the reference's ``lax.scan`` sums them from zeros, then
divided by ``accum``.  Optional gradient compression
(``repro_torch.distributed.compression``) hooks in between accumulation
and the optimizer update.  The forward of every layer launches the
flash-attention kernel on the card (:class:`repro_torch.kernels.
flash_attention.FlashAttention`), again when the backward recomputes
the layer under ``cfg.remat``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models.registry import ModelAPI
from ..optim.adamw import tree_leaves, tree_map


def _split_microbatches(batch: Dict[str, Any], accum: int):
    def resh(x):
        b = x.shape[0]
        assert b % accum == 0, (b, accum)
        return x.reshape(accum, b // accum, *x.shape[1:])
    mbs = {k: resh(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in mbs.items()} for i in range(accum)]


def make_train_step(
    model: ModelAPI,
    optimizer,
    grad_accum: Optional[int] = None,
    grad_transform: Optional[Callable] = None,
) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    metrics ``loss``, ``grad_norm``, ``lr`` (and the loss's ``ce``,
    ``aux``, ``tokens`` without accumulation), as the reference's.  The
    optimizer updates ``params`` in place and returns them."""
    cfg = model.cfg
    accum = grad_accum if grad_accum is not None else cfg.grad_accum

    def train_step(params, opt_state, batch):
        # leaves that share the parameters' memory and collect gradients
        live = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        metrics: Dict[str, Any] = {}
        if accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_microbatches(batch, accum):
                mb_loss, _ = model.loss(live, mb)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            loss = loss / accum
        else:
            loss, metrics = model.loss(live, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, live)
        if accum > 1:
            for g in tree_leaves(grads):
                g.div_(accum)
        del live
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, opt_state, params)
        out = {"loss": loss, **opt_metrics}
        for k, v in metrics.items():
            out[k] = v
        return new_params, new_opt, out

    return train_step
