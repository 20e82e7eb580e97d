"""``--arch <id>`` -> unified model API (init / forward / decode).

Mirror of ``repro.models.registry`` for the dense family.  A model is
built for one device — the card unless the caller asks for the CPU — and
its ``init`` and ``decode_init`` allocate there.  ``loss`` is the
reference's ``lm_loss`` (the training path: ``repro_torch.training``);
the reference's ``mesh`` arguments and sharding axes have no counterpart
on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..configs import unported_family
from . import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    device: torch.device
    init: Callable         # (seed or torch.Generator) -> params
    loss: Callable         # (params, batch) -> (loss, metrics)
    forward: Callable      # (params, batch) -> logits  (prefill)
    decode_init: Callable  # (batch, kv_len) -> caches
    decode_step: Callable  # (params, caches, token, pos, active=None)
    #                        -> (logits, caches)


def build_model(cfg, device: Optional[Union[str, torch.device]] = None
                ) -> ModelAPI:
    """The model of ``cfg`` on ``device`` (default ``"cuda"``)."""
    if cfg.family != "dense":
        raise unported_family(cfg.family)
    dev = torch.device(device or "cuda")

    def init(seed: Union[int, torch.Generator] = 0):
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return T.init_lm(cfg, gen)

    def forward(params, batch):
        return T.lm_forward(params, cfg, batch["tokens"])

    return ModelAPI(
        cfg=cfg, device=dev, init=init, forward=forward,
        loss=lambda params, batch: T.lm_loss(params, cfg, batch),
        decode_init=lambda batch, kv_len: T.init_decode_state(
            cfg, batch, kv_len, dev),
        decode_step=lambda params, caches, token, pos, active=None:
            T.lm_decode_step(params, cfg, caches, token, pos, active),
    )
