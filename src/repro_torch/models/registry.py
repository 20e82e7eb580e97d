"""``--arch <id>`` -> unified model API (init / loss / forward / decode).

Mirror of ``repro.models.registry``: the audio family is the
encoder-decoder of :mod:`.encdec`, every other family the decoder-only
LM of :mod:`.transformer`.  A model is built for one device — the card
unless the caller asks for the CPU — and its ``init`` and
``decode_init`` allocate there.  ``forward`` reads ``batch["tokens"]``,
a vlm's ``batch["patches"]`` and audio's ``batch["frames"]``; ``loss``
is the reference's ``lm_loss`` / ``encdec_loss`` (the training path:
``repro_torch.training``), ``loss(params, batch, mesh)`` on a mesh.

The reference's ``init`` returns ``(params, axes)`` and ``decode_init``
``(caches, axes)``; here ``init`` and ``decode_init`` return the tensors
and :attr:`ModelAPI.axes` / :attr:`ModelAPI.decode_axes` the logical
axes trees.  ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, one
process per device) places them by those axes — ``init(seed,
mesh=mesh)`` draws each leaf whole from the seed and keeps this rank's
block, so a sharded model has the unsharded one's weights, and
:func:`shard_params` places a full tree — and ``forward(params, batch,
mesh)`` / ``decode_step(..., mesh=mesh)`` run the models' mesh path,
returning DTensor logits (``full_tensor()`` gathers them), and
``loss(params, batch, mesh)`` the global batch's loss, differentiable
through the mesh bodies (``training.make_train_step(mesh=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..sharding.axes import distribute, tree_zip_map
from . import encdec as ED
from . import layers as L
from . import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    device: torch.device
    init: Callable         # (seed or torch.Generator, mesh=None) -> params
    loss: Callable         # (params, batch, mesh=None) -> (loss, metrics)
    forward: Callable      # (params, batch, mesh=None) -> logits (prefill)
    decode_init: Callable  # (batch, kv_len, mesh=None) -> caches
    decode_step: Callable  # (params, caches, token, pos, active=None,
    #                         mesh=None) -> (logits, caches)
    axes: Callable         # () -> the parameters' logical axes tree
    decode_axes: Callable  # () -> the caches' logical axes tree


def shard_params(params, axes, mesh):
    """A full parameter tree (the same on every rank) placed on ``mesh``
    by its logical ``axes``: each rank keeps its block.  A leaf of no
    axes (``()``: the optimizer state's step, :meth:`repro_torch.optim.
    AdamW.state_axes`) stays as it is."""
    return tree_zip_map(lambda ax, t: t if ax == () else
                        distribute(t, ax, mesh), axes, params)


def build_model(cfg, device: Optional[Union[str, torch.device]] = None
                ) -> ModelAPI:
    """The model of ``cfg`` on ``device`` (default ``"cuda"``)."""
    audio = cfg.family == "audio"
    if not audio:
        T._check_family(cfg)
    dev = torch.device(device or "cuda")
    init_fn = ED.init_encdec if audio else T.init_lm

    def init(seed: Union[int, torch.Generator] = 0, mesh=None):
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        if mesh is None:
            return init_fn(cfg, gen)
        with L.placing(lambda t, ax: distribute(t, ax, mesh)):
            return init_fn(cfg, gen)

    common = dict(cfg=cfg, device=dev, init=init,
                  axes=lambda: init_fn(cfg, None))
    if audio:
        def forward(params, batch, mesh=None):
            enc = ED.encode(params, cfg, batch["frames"], mesh)
            return ED.decode_train(params, cfg, batch["tokens"], enc, mesh)

        return ModelAPI(
            forward=forward,
            loss=lambda params, batch, mesh=None: ED.encdec_loss(
                params, cfg, batch, mesh),
            decode_init=lambda batch, kv_len, mesh=None: ED.init_decode_state(
                cfg, batch, kv_len, dev, mesh=mesh),
            decode_step=lambda params, caches, token, pos, active=None,
            mesh=None: ED.encdec_decode_step(params, cfg, caches, token, pos,
                                             active, mesh),
            decode_axes=lambda: ED.decode_axes(cfg), **common)

    def forward(params, batch, mesh=None):
        return T.lm_forward(params, cfg, batch["tokens"],
                            batch.get("patches"), mesh)[0]

    return ModelAPI(
        forward=forward,
        loss=lambda params, batch, mesh=None: T.lm_loss(params, cfg, batch,
                                                        mesh),
        decode_init=lambda batch, kv_len, mesh=None: T.init_decode_state(
            cfg, batch, kv_len, dev, mesh=mesh),
        decode_step=lambda params, caches, token, pos, active=None,
        mesh=None: T.lm_decode_step(params, cfg, caches, token, pos, active,
                                    mesh),
        decode_axes=lambda: T.decode_axes(cfg), **common)
