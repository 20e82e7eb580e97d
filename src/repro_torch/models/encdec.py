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
:func:`.attention.attend_cache`, which computes the reference's
``chunked_attention`` (f32 scores).

``mesh=`` runs the same functions on placed parameters (DTensors) with
the reference's constraints (``encdec.py``: the frontend's and the
embedding's outputs to ``("batch", None, "act_embed")``, logits
``act_vocab``); the blocks are :mod:`.attention`'s and :mod:`.layers`',
the cross attention a local-heads body of its own, each one body that
runs on plain tensors or on local shards.  Decode carries the embed dim
over ``data`` as the decoder-only models do (the reference leaves
decode's layout to propagation); the cross caches are attended where
they lie, sequence-sharded ones with the split softmax of
:func:`.attention.attend_cache`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..sharding import shard_activation
from ..sharding.axes import zeros as mesh_zeros
from ..sharding.collectives import Local
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
        "wq": ((E, Hq, Dh), ("embed", "heads", "head_dim"), std),
        "wk": ((E, Hkv, Dh), ("embed", "kv_heads", "head_dim"), std),
        "wv": ((E, Hkv, Dh), ("embed", "kv_heads", "head_dim"), std),
        "wo": ((Hq, Dh, E), ("heads", "head_dim", "embed"),
               L.fan_in_std(Hq * Dh)),
    }, dtype)


def _norm(gen, cfg, dtype):
    return L.declare(gen, {"w": ((cfg.d_model,), ("embed_r",), 0.0)},
                     dtype)


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


def init_encdec(cfg, gen: Optional[torch.Generator]) -> Dict[str, Any]:
    """Parameters in ``cfg.param_dtype`` on ``gen``'s device;
    ``gen=None``: their logical axes."""
    dtype = L.dtype_of(cfg.param_dtype)
    return {
        "frontend": L.declare(gen, {
            "w": ((cfg.d_model, cfg.d_model), (None, "act_mlp"),
                  L.fan_in_std(cfg.d_model)),
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


def _enc_kv(p, enc_out, compute_dtype):
    return (A._proj(enc_out, p["wk"], compute_dtype),
            A._proj(enc_out, p["wv"], compute_dtype))


def _cross_attention(p, x, enc_out, compute_dtype):
    """The full-sequence cross attention: x (b, sq, E) against the
    encoder output (b, s_enc, E), through ``ops.attention`` (the flash
    kernel on the card).  On a mesh each rank takes its local q heads
    and the kv heads they read, projected from the (batch-sharded)
    encoder output, and reduces the partial sums over ``model``."""
    loc = Local.of(x)
    ws = [L.gather_data(p[n], compute_dtype) for n in A._W]
    q_axes, kv_axes = L.sharded_axes(ws[0], 1), L.sharded_axes(ws[1], 1)
    n_heads, n_kv = ws[0].shape[1], ws[1].shape[1]

    def body(xl, el, wq, wk, wv, wo):
        q = A._proj(xl, wq, compute_dtype)
        k, v = _enc_kv({"wk": wk, "wv": wv}, el, compute_dtype)
        k, v = A.kv_for_local_q(k, v, q_axes, kv_axes, n_heads, n_kv, loc)
        out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=False)
        return loc.all_reduce(A._out_proj(out, wo, compute_dtype), q_axes)

    return L.on_shards(body, L.placements_of(x), x, enc_out, *ws)


def _cross_decode(p, x, xk, xv, cfg, compute_dtype):
    """Decode's cross attention: every row's query against the cached
    encoder keys and values (:func:`.attention.attend_cache`, the
    reference's ``chunked_attention`` with f32 scores).  On a mesh the
    query's embed dim lies over ``data`` or whole, the caches are read
    where they lie, the rows gathered over the batch shards and the
    partial sums reduced over ``model``."""
    loc = Local.of(x)
    e_axes = L.sharded_axes(x, 2)
    wq, wo = L.mesh_weights(x, [p["wq"], p["wo"]], compute_dtype)
    q_axes = L.sharded_axes(wq, 1)
    kv_axes = L.sharded_axes(xk, 1)
    b_axes, seq_axes = L.sharded_axes(xk, 0), L.sharded_axes(xk, 2)
    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)

    def body(xl, wql, wol, kl, vl):
        q = loc.all_reduce(A._proj(xl, wql, compute_dtype), e_axes)
        bc = kl.shape[0]
        r = loc.rank(b_axes)
        q = q[r * bc:(r + 1) * bc, :, 0]
        valid = torch.ones((bc, kl.shape[2]), dtype=torch.bool,
                           device=kl.device)
        out = A.attend_cache(q, kl, vl, valid, q_axes=q_axes,
                             kv_axes=kv_axes, seq_axes=seq_axes,
                             n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                             loc=loc, scale=scale)
        out = loc.all_gather(out, b_axes, dim=0)[:, :, None, :]
        return loc.all_reduce(A._out_proj(out, wol, compute_dtype), q_axes)

    return L.on_shards(body, L.placements_of(x), x, wq, wo, xk, xv)


def _add_positions(x, positions, cfg, compute_dtype):
    """``x + sinusoid(positions)``; on a mesh each rank adds its embed
    slice (dim 2 may be sharded)."""
    loc = Local.of(x)
    axes = L.sharded_axes(x, 2)

    def body(xl):
        n = xl.shape[-1]
        r = loc.rank(axes)
        pe = _sinusoid(positions.to(xl.device), cfg.d_model)
        return xl + pe[..., r * n:(r + 1) * n].to(compute_dtype)

    return L.on_shards(body, L.placements_of(x), x)


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


def encode(params, cfg, frames: torch.Tensor, mesh=None) -> torch.Tensor:
    """frames (b, s_frames, d_model) -> encoder output, same shape, in
    ``cfg.dtype``."""
    from torch.distributed.tensor import Shard

    compute_dtype = L.dtype_of(cfg.dtype)
    w = params["frontend"]["w"].to(compute_dtype)
    frames = shard_activation(frames, ("batch", None, None), mesh)
    out = None if mesh is None else [
        Shard(2) if isinstance(wp, Shard) else fp
        for fp, wp in zip(frames.placements, w.placements)]
    x = L.on_shards(lambda wl, fl: fl.to(compute_dtype) @ wl, out, w,
                    frames)
    pos = torch.arange(x.shape[1], device=L.local_device(x))[None]
    x = _add_positions(x, pos, cfg, compute_dtype)
    x = shard_activation(x, ("batch", None, "act_embed"), mesh)
    x = _layers(_enc_body, params["enc_layers"], x, cfg, cfg, compute_dtype)
    return L.rms_norm(x, params["ln_enc"]["w"], cfg.norm_eps)


def _dec_body(lp, x, enc_out, cfg, compute_dtype):
    h = L.rms_norm(x, lp["ln_self"]["w"], cfg.norm_eps)
    x = x + A.attention_block(lp["self"], h, cfg, theta=None, window=None,
                              compute_dtype=compute_dtype, causal=True)
    h = L.rms_norm(x, lp["ln_cross"]["w"], cfg.norm_eps)
    x = x + _cross_attention(lp["cross"], h, enc_out, compute_dtype)
    h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
    return x + L.gelu_mlp(lp["mlp"], h, compute_dtype)


def decode_train(params, cfg, tokens: torch.Tensor,
                 enc_out: torch.Tensor, mesh=None) -> torch.Tensor:
    """tokens (b, s) against the encoder output -> logits (b, s,
    padded_vocab) in ``cfg.dtype``."""
    compute_dtype = L.dtype_of(cfg.dtype)
    x = L.embed(params["embed"], tokens, compute_dtype, mesh)
    pos = torch.arange(x.shape[1], device=L.local_device(x))[None]
    x = _add_positions(x, pos, cfg, compute_dtype)
    x = shard_activation(x, ("batch", None, "act_embed"), mesh)
    x = _layers(_dec_body, params["dec_layers"], x, cfg, enc_out, cfg,
                compute_dtype)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
    return L.lm_head(params["head"], x, compute_dtype)


def encdec_loss(params, cfg, batch, mesh=None):
    """Mean next-token CE of the decoder over valid (label >= 0)
    positions -> (loss, {"ce", "tokens"}); on a mesh over the global
    batch, the same on every rank (:func:`.transformer._ce`)."""
    enc_out = encode(params, cfg, batch["frames"], mesh)
    logits = decode_train(params, cfg, batch["tokens"], enc_out, mesh)
    ce, denom = T._ce(logits, batch["labels"], cfg)
    return ce / denom, {"ce": ce / denom, "tokens": denom}


# --------------------------------------------------------------------- #
# decode: self cache per layer + precomputed cross k/v
# --------------------------------------------------------------------- #
def decode_axes(cfg) -> List[Dict[str, Any]]:
    """The logical axes of :func:`init_decode_state`'s caches."""
    kv = T.KV_AXES
    return [{"k": kv, "v": kv, "xk": kv, "xv": kv}
            for _ in range(cfg.n_layers)]


def init_decode_state(cfg, batch: int, kv_len: int, device,
                      cross_len: int = CROSS_LEN, mesh=None
                      ) -> List[Dict[str, torch.Tensor]]:
    """Per decoder layer: the self-attention cache ``k``, ``v`` (batch,
    hkv, kv_len, dh) and the cross cache ``xk``, ``xv`` (batch, hkv,
    cross_len, dh), zeros in ``cfg.dtype`` (on a mesh, DTensors laid out
    by :func:`decode_axes`)."""
    dtype = L.dtype_of(cfg.dtype)
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(n):
        shape = (batch, Hkv, n, Dh)
        if mesh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return mesh_zeros(shape, T.KV_AXES, mesh, dtype=dtype,
                          device=device)

    return [{"k": zeros(kv_len), "v": zeros(kv_len),
             "xk": zeros(cross_len), "xv": zeros(cross_len)}
            for _ in range(cfg.n_layers)]


def encdec_decode_step(params, cfg, caches, token: torch.Tensor, pos,
                       active: Optional[torch.Tensor] = None, mesh=None):
    """token: (b, 1) int; pos: scalar or (b,) int; active: optional (b,)
    bool -> (logits (b, vp), new caches).  The cross caches are read,
    never written."""
    compute_dtype = L.dtype_of(cfg.dtype)
    b = token.shape[0]
    x = L.embed(params["embed"], token, compute_dtype, mesh)
    x = shard_activation(x, (None, None, "act_decode_embed"), mesh)
    pos_vec = torch.broadcast_to(
        torch.as_tensor(pos, device=L.local_device(x)).reshape(-1), (b,))
    x = _add_positions(x, pos_vec[:, None], cfg, compute_dtype)
    new_caches = []
    for lp, cache in zip(params["dec_layers"], caches):
        c = dict(cache)
        h = L.rms_norm(x, lp["ln_self"]["w"], cfg.norm_eps)
        y, c["k"], c["v"] = A.decode_attention_block(
            lp["self"], h, c["k"], c["v"], pos, cfg, theta=None,
            window=None, compute_dtype=compute_dtype, active=active)
        x = x + y
        h = L.rms_norm(x, lp["ln_cross"]["w"], cfg.norm_eps)
        x = x + _cross_decode(lp["cross"], h, c["xk"], c["xv"], cfg,
                              compute_dtype)
        h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
        x = x + L.gelu_mlp(lp["mlp"], h, compute_dtype)
        new_caches.append(c)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
    logits = T.first_position(L.lm_head(params["head"], x, compute_dtype))
    return logits, new_caches
