"""Training step: remat'd forward/backward, microbatch gradient
accumulation, global-norm clipping, AdamW update.

Mirror of ``repro.training.steps``, on one device or on a (data, model)
``DeviceMesh`` (``mesh=``).  One ``loss.backward()`` per microbatch, the
gradients summed in the parameters' dtype (float32, ``param_dtype``) over
``accum`` microbatches in order, as the reference's ``lax.scan`` sums
them from zeros, then divided by ``accum``.  Optional gradient
compression (``repro_torch.distributed.compression``) hooks in between
accumulation and the optimizer update.  The forward of every layer
launches the flash-attention kernel on the card (:class:`repro_torch.
kernels.flash_attention.FlashAttention`), again when the backward
recomputes the layer under ``cfg.remat``.

On a mesh the parameters and the optimizer state are DTensors placed by
their logical axes and the batch is placed by ``batch`` (or given whole,
the same on every rank).  Microbatch ``i`` holds rows ``[i B / accum,
(i + 1) B / accum)`` of the global batch, as the reference's
``_split_microbatches`` cuts it, sharded over the data axes.  Where the
reference leaves the gradients' reduction to pjit, here it is explicit,
once a step: the step gathers each parameter over the data axes once
(the reference's ZeRO-3 gathers again at every use), so the gradients
of the gathered copies (partial sums over ``data``, and over ``model``
where a parameter is whole on it: ``local_map``'s gradient placements)
accumulate over the microbatches without a collective and are reduced
to each parameter's placements after the last one.  The loss is the
mean CE over the global batch's valid tokens (``ModelAPI.loss(...,
mesh)``), the same on every rank.

With ``obs`` on, each step records the span ``train.step`` with the
children ``train.forward`` (``model.loss``), ``train.backward``
(``loss.backward()``, the remat recompute included; one of each per
microbatch under accumulation, attribute ``mb``) and ``train.optimizer``
(the gradients gathered, clipped and applied).  The device work the
autograd engine's thread launches falls inside ``train.backward``, which
the calling thread holds open while it runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models import layers as L
from ..models.registry import ModelAPI
from ..obs import NULL_OBS, Obs
from ..optim.adamw import tree_leaves, tree_map


def _split_microbatches(batch: Dict[str, Any], accum: int):
    def resh(x):
        b = x.shape[0]
        assert b % accum == 0, (b, accum)
        return x.reshape(accum, b // accum, *x.shape[1:])
    mbs = {k: resh(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in mbs.items()} for i in range(accum)]


def _gathered_over_data(p):
    """``p`` whole over the data axes of extent > 1 (its ``model`` shard
    kept; an axis of extent 1 splits nothing, and is left so that no
    copy is made)."""
    from torch.distributed.tensor import Replicate

    mesh = p.device_mesh
    names = L.mesh_axis_names(mesh)
    return L.with_placements(p, [
        Replicate() if n in L.DATA_AXES and mesh.size(d) > 1 else pl
        for d, (n, pl) in enumerate(zip(names, p.placements))])


def make_train_step(
    model: ModelAPI,
    optimizer,
    mesh=None,
    grad_accum: Optional[int] = None,
    grad_transform: Optional[Callable] = None,
    obs: Obs = NULL_OBS,
) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    metrics ``loss``, ``grad_norm``, ``lr`` (and the loss's ``ce``,
    ``aux``, ``tokens`` without accumulation), as the reference's.  The
    optimizer updates ``params`` in place and returns them.  ``mesh``:
    the ``DeviceMesh`` the parameters lie on (see the module's
    docstring); ``obs``: the handle the step's spans go to."""
    cfg = model.cfg
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    tracer = obs.tracer

    def leaf(p):
        if mesh is not None and L.is_dtensor(p):
            with torch.no_grad():
                p = _gathered_over_data(p)
        return p.detach().requires_grad_(p.is_floating_point())

    def train_step(params, opt_state, batch):
        with tracer.span("train.step"):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        # leaves that collect gradients (on one device they share the
        # parameters' memory)
        live = tree_map(leaf, params)
        if mesh is not None:
            batch = {k: v.full_tensor() if L.is_dtensor(v) else v
                     for k, v in batch.items()}
        metrics: Dict[str, Any] = {}
        if accum > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=L.local_device(
                                   tree_leaves(params)[0]))
            for i, mb in enumerate(_split_microbatches(batch, accum)):
                with tracer.span("train.forward", mb=i):
                    mb_loss, _ = model.loss(live, mb, mesh)
                with tracer.span("train.backward", mb=i):
                    mb_loss.backward()
                loss = loss + mb_loss.detach()
            loss = loss / accum
        else:
            with tracer.span("train.forward"):
                loss, metrics = model.loss(live, batch, mesh)
            with tracer.span("train.backward"):
                loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        with tracer.span("train.optimizer"):
            grads = tree_map(lambda p: torch.zeros_like(p)
                             if p.grad is None else p.grad, live)
            if mesh is not None:
                # the step's one reduction of each gradient
                grads = tree_map(
                    lambda g, p: L.with_placements(g, p.placements)
                    if L.is_dtensor(g) else g, grads, params)
            if accum > 1:
                for g in tree_leaves(grads):
                    (g.to_local() if L.is_dtensor(g) else g).div_(accum)
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
