"""``--arch <id>`` -> unified model API (init / loss / forward / decode).

Mirror of ``repro.models.registry``: the audio family is the
encoder-decoder of :mod:`.encdec`, every other family the decoder-only
LM of :mod:`.transformer`.  A model is built for one device — the card
unless the caller asks for the CPU — and its ``init`` and
``decode_init`` allocate there.  ``forward`` reads ``batch["tokens"]``,
a vlm's ``batch["patches"]`` and audio's ``batch["frames"]``; ``loss``
is the reference's ``lm_loss`` / ``encdec_loss`` (the training path:
``repro_torch.training``).  The reference's ``mesh`` arguments and
sharding axes have no counterpart on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from . import encdec as ED
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
    audio = cfg.family == "audio"
    if not audio:
        T._check_family(cfg)
    dev = torch.device(device or "cuda")

    def init(seed: Union[int, torch.Generator] = 0):
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return ED.init_encdec(cfg, gen) if audio else T.init_lm(cfg, gen)

    if audio:
        def forward(params, batch):
            enc = ED.encode(params, cfg, batch["frames"])
            return ED.decode_train(params, cfg, batch["tokens"], enc)

        return ModelAPI(
            cfg=cfg, device=dev, init=init, forward=forward,
            loss=lambda params, batch: ED.encdec_loss(params, cfg, batch),
            decode_init=lambda batch, kv_len: ED.init_decode_state(
                cfg, batch, kv_len, dev),
            decode_step=lambda params, caches, token, pos, active=None:
                ED.encdec_decode_step(params, cfg, caches, token, pos,
                                      active),
        )

    def forward(params, batch):
        return T.lm_forward(params, cfg, batch["tokens"],
                            batch.get("patches"))[0]

    return ModelAPI(
        cfg=cfg, device=dev, init=init, forward=forward,
        loss=lambda params, batch: T.lm_loss(params, cfg, batch),
        decode_init=lambda batch, kv_len: T.init_decode_state(
            cfg, batch, kv_len, dev),
        decode_step=lambda params, caches, token, pos, active=None:
            T.lm_decode_step(params, cfg, caches, token, pos, active),
    )
