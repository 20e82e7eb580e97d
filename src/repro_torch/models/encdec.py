"""Whisper-style encoder–decoder backbone.

Mirror of ``repro.models.encdec``.  The audio conv frontend is a stub,
as there: the caller feeds precomputed frame embeddings (b, s_frames,
d_model) and a linear adapter stands in for the conv stack.  Positions
are sinusoidal on both sides, norms RMSNorm, MLPs GELU (tanh).

The encoder's self-attention (non-causal), the decoder's causal
self-attention and its full-sequence cross-attention go through
:func:`repro_torch.kernels.ops.attention`, so each launches the
flash-attention kernel on the card: ``n_encoder_layers + 2 * n_layers``
launches a forward.  Decode attends in plain torch, as the decoder-only
models' decode does: its self-attention through
:func:`.attention.decode_attention_block`, its cross-attention (one
token against the ``CROSS_LEN`` cached frames) through
:func:`_plain_attention`, which computes the reference's
``chunked_attention`` (f32 scores).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from . import attention as A
from . import layers as L
from . import transformer as T

CROSS_LEN = 1500  # whisper's fixed 30 s encoder length

f32 = torch.float32


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    dev = positions.device
    freq = torch.exp(
        -torch.log(torch.full((), 10000.0, dtype=f32, device=dev))
        * torch.arange(half, dtype=f32, device=dev) / half)
    ang = positions[..., None].to(f32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_cross_attention(gen, cfg, dtype):
    E, Hq, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    std = L.fan_in_std(E)
    return L.declare(gen, {
        "wq": ((E, Hq, Dh), std),
        "wk": ((E, Hkv, Dh), std),
        "wv": ((E, Hkv, Dh), std),
        "wo": ((Hq, Dh, E), L.fan_in_std(Hq * Dh)),
    }, dtype)


def _norm(gen, cfg, dtype):
    return L.declare(gen, {"w": ((cfg.d_model,), 0.0)}, dtype)


def _init_enc_layer(gen, cfg, dtype):
    return {
        "attn": A.init_attention(gen, cfg, dtype),
        "ln_attn": _norm(gen, cfg, dtype),
        "mlp": L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
        "ln_mlp": _norm(gen, cfg, dtype),
    }


def _init_dec_layer(gen, cfg, dtype):
    return {
        "self": A.init_attention(gen, cfg, dtype),
        "ln_self": _norm(gen, cfg, dtype),
        "cross": _init_cross_attention(gen, cfg, dtype),
        "ln_cross": _norm(gen, cfg, dtype),
        "mlp": L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
        "ln_mlp": _norm(gen, cfg, dtype),
    }


def init_encdec(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Parameters in ``cfg.param_dtype`` on ``gen``'s device."""
    dtype = L.dtype_of(cfg.param_dtype)
    return {
        "frontend": L.declare(gen, {
            "w": ((cfg.d_model, cfg.d_model), L.fan_in_std(cfg.d_model)),
        }, dtype),
        "embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_layers": [_init_enc_layer(gen, cfg, dtype)
                       for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg, dtype)
                       for _ in range(cfg.n_layers)],
        "ln_enc": _norm(gen, cfg, dtype),
        "ln_f": _norm(gen, cfg, dtype),
        "head": L.init_lm_head(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }


def _plain_attention(q, k, v) -> torch.Tensor:
    """Unmasked GQA attention in plain torch with f32 scores, as the
    reference's ``chunked_attention(causal=False)``."""
    b, hq, sq, dh = q.shape
    hkv = k.shape[1]
    scale = 1.0 / dh ** 0.5
    qg = q.reshape(b, hkv, hq // hkv, sq, dh).to(f32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f32)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return out.reshape(b, hq, sq, dh)


def _cross_attention(p, x, enc_k, enc_v, compute_dtype,
                     kernel: bool = True) -> torch.Tensor:
    """x: (b, sq, E); enc_k/v: (b, hkv, s_enc, dh).  ``kernel``: through
    ``ops.attention`` (the flash kernel on the card), else
    :func:`_plain_attention`."""
    q = A._proj(x, p["wq"], compute_dtype)
    if kernel:
        out = ops.attention(q.contiguous(), enc_k.contiguous(),
                            enc_v.contiguous(), causal=False)
    else:
        out = _plain_attention(q, enc_k, enc_v)
    return A._out_proj(out, p["wo"], compute_dtype)


def _enc_kv(p, enc_out, compute_dtype):
    return (A._proj(enc_out, p["wk"], compute_dtype),
            A._proj(enc_out, p["wv"], compute_dtype))


def _layers(body, layers, x, cfg, *args):
    """``x`` through ``body(lp, x, *args)`` for each layer, each under
    ``torch.utils.checkpoint`` when gradients are taken and
    ``cfg.remat`` is set (the reference's ``jax.checkpoint``)."""
    for lp in layers:
        if cfg.remat and T._takes_grad(lp, x):
            x = checkpoint(body, lp, x, *args, use_reentrant=False)
        else:
            x = body(lp, x, *args)
    return x


def _enc_body(lp, x, cfg, compute_dtype):
    h = L.rms_norm(x, lp["ln_attn"]["w"], cfg.norm_eps)
    x = x + A.attention_block(lp["attn"], h, cfg, theta=None, window=None,
                              compute_dtype=compute_dtype, causal=False)
    h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
    return x + L.gelu_mlp(lp["mlp"], h, compute_dtype)


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (b, s_frames, d_model) -> encoder output, same shape, in
    ``cfg.dtype``."""
    compute_dtype = L.dtype_of(cfg.dtype)
    x = frames.to(compute_dtype) @ params["frontend"]["w"].to(compute_dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x = x + _sinusoid(pos, cfg.d_model).to(compute_dtype)
    x = _layers(_enc_body, params["enc_layers"], x, cfg, cfg, compute_dtype)
    return L.rms_norm(x, params["ln_enc"]["w"], cfg.norm_eps)


def _dec_body(lp, x, enc_out, cfg, compute_dtype):
    h = L.rms_norm(x, lp["ln_self"]["w"], cfg.norm_eps)
    x = x + A.attention_block(lp["self"], h, cfg, theta=None, window=None,
                              compute_dtype=compute_dtype, causal=True)
    h = L.rms_norm(x, lp["ln_cross"]["w"], cfg.norm_eps)
    ek, ev = _enc_kv(lp["cross"], enc_out, compute_dtype)
    x = x + _cross_attention(lp["cross"], h, ek, ev, compute_dtype)
    h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
    return x + L.gelu_mlp(lp["mlp"], h, compute_dtype)


def decode_train(params, cfg, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """tokens (b, s) against the encoder output -> logits (b, s,
    padded_vocab) in ``cfg.dtype``."""
    compute_dtype = L.dtype_of(cfg.dtype)
    x = L.embed(params["embed"], tokens, compute_dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x = x + _sinusoid(pos, cfg.d_model).to(compute_dtype)
    x = _layers(_dec_body, params["dec_layers"], x, cfg, enc_out, cfg,
                compute_dtype)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
    return L.lm_head(params["head"], x, compute_dtype)


def encdec_loss(params, cfg, batch):
    """Mean next-token CE of the decoder over valid (label >= 0)
    positions -> (loss, {"ce", "tokens"})."""
    enc_out = encode(params, cfg, batch["frames"])
    logits = decode_train(params, cfg, batch["tokens"], enc_out)
    ce, denom = T._ce(logits, batch["labels"], cfg)
    return ce / denom, {"ce": ce / denom, "tokens": denom}


# --------------------------------------------------------------------- #
# decode: self cache per layer + precomputed cross k/v
# --------------------------------------------------------------------- #
def init_decode_state(cfg, batch: int, kv_len: int, device,
                      cross_len: int = CROSS_LEN
                      ) -> List[Dict[str, torch.Tensor]]:
    """Per decoder layer: the self-attention cache ``k``, ``v`` (batch,
    hkv, kv_len, dh) and the cross cache ``xk``, ``xv`` (batch, hkv,
    cross_len, dh), zeros in ``cfg.dtype``."""
    dtype = L.dtype_of(cfg.dtype)
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(n):
        return torch.zeros((batch, Hkv, n, Dh), dtype=dtype, device=device)

    return [{"k": zeros(kv_len), "v": zeros(kv_len),
             "xk": zeros(cross_len), "xv": zeros(cross_len)}
            for _ in range(cfg.n_layers)]


def encdec_decode_step(params, cfg, caches, token: torch.Tensor, pos,
                       active: Optional[torch.Tensor] = None):
    """token: (b, 1) int; pos: scalar or (b,) int; active: optional (b,)
    bool -> (logits (b, vp), new caches).  The cross caches are read,
    never written."""
    compute_dtype = L.dtype_of(cfg.dtype)
    b = token.shape[0]
    x = L.embed(params["embed"], token, compute_dtype)
    pos_vec = torch.broadcast_to(
        torch.as_tensor(pos, device=x.device).reshape(-1), (b,))
    x = x + _sinusoid(pos_vec[:, None], cfg.d_model).to(compute_dtype)
    new_caches = []
    for lp, cache in zip(params["dec_layers"], caches):
        c = dict(cache)
        h = L.rms_norm(x, lp["ln_self"]["w"], cfg.norm_eps)
        y, c["k"], c["v"] = A.decode_attention_block(
            lp["self"], h, c["k"], c["v"], pos, cfg, theta=None,
            window=None, compute_dtype=compute_dtype, active=active)
        x = x + y
        h = L.rms_norm(x, lp["ln_cross"]["w"], cfg.norm_eps)
        x = x + _cross_attention(lp["cross"], h, c["xk"], c["xv"],
                                 compute_dtype, kernel=False)
        h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
        x = x + L.gelu_mlp(lp["mlp"], h, compute_dtype)
        new_caches.append(c)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
    logits = L.lm_head(params["head"], x, compute_dtype)[:, 0]
    return logits, new_caches
