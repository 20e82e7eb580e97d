"""GQA attention block: full-sequence (prefill) path + decode path.

Mirror of ``repro.models.attention``.  The full-sequence block calls
:func:`repro_torch.kernels.ops.attention`, which launches the
hand-written flash-attention kernel on the card (the plain version on
the CPU): the slot the reference reserves for its Pallas kernel, where
it runs the plain ``chunked_attention``.  Both compute the same
function: GQA, causal mask, sliding window, f32 scores.  The decode path
attends one token against the KV cache in plain torch, as the reference
does in jnp.  The reference's ``shard_activation`` calls are no-ops
outside a mesh and are dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops
from . import layers as L

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32):
    E = cfg.d_model
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    std = L.fan_in_std(E)
    decls = {
        "wq": ((E, Hq, Dh), std),
        "wk": ((E, Hkv, Dh), std),
        "wv": ((E, Hkv, Dh), std),
        "wo": ((Hq, Dh, E), L.fan_in_std(Hq * Dh)),
    }
    if cfg.qkv_bias:
        decls.update({
            "bq": ((Hq, Dh), 0.0),
            "bk": ((Hkv, Dh), 0.0),
            "bv": ((Hkv, Dh), 0.0),
        })
    return L.declare(gen, decls, dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """einsum('bse,ehd->bhsd') as one matmul: (b, s, E) -> (b, h, s, d)."""
    E, H, D = w.shape
    b, s, _ = x.shape
    y = x @ w.to(compute_dtype).reshape(E, H * D)
    return y.view(b, s, H, D).transpose(1, 2)


def _project_qkv(p, x, cfg, compute_dtype):
    q = _proj(x, p["wq"], compute_dtype)
    k = _proj(x, p["wk"], compute_dtype)
    v = _proj(x, p["wv"], compute_dtype)
    if "bq" in p:
        q = q + p["bq"].to(compute_dtype)[None, :, None, :]
        k = k + p["bk"].to(compute_dtype)[None, :, None, :]
        v = v + p["bv"].to(compute_dtype)[None, :, None, :]
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """einsum('bhsd,hde->bse')."""
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d) \
        @ wo.to(compute_dtype).reshape(h * d, -1)


def attention_block(p: Dict[str, Any], x: torch.Tensor, cfg, *, theta,
                    window: Optional[int], compute_dtype,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence (prefill) attention block; ``window`` None = full
    attention (the reference's traced ``-1``), ``causal=False`` for an
    encoder; ``theta`` None = no RoPE."""
    q, k, v = _project_qkv(p, x, cfg, compute_dtype)
    if theta is not None:
        positions = torch.arange(x.shape[1], device=x.device)[None, None, :]
        q = L.rope(q, positions, theta)
        k = L.rope(k, positions, theta)
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, window=window)
    return _out_proj(out, p["wo"], compute_dtype)


# --------------------------------------------------------------------- #
# decode path
# --------------------------------------------------------------------- #
def decode_attention_block(
    p: Dict[str, Any], x: torch.Tensor, cache_k: torch.Tensor,
    cache_v: torch.Tensor, pos, cfg, *, theta, window: Optional[int],
    compute_dtype, windowed_cache: bool = False,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (b, 1, E); cache_k/v: (b, hkv, S, dh).

    ``pos``: scalar (int or 0-d tensor) or per-row (b,) int tensor — the
    absolute position of each row's new token (continuous batching).
    ``active``: optional (b,) bool; inactive rows leave their cache
    untouched.  Returns new caches; the inputs are not modified.

    Full cache: written at slot pos (a scalar pos is clamped into
    ``[0, S-1]`` like ``dynamic_update_slice``; a per-row pos outside
    ``[0, S)`` writes nothing, as the reference's scatter drops a pos
    >= S — the serving engine passes neither).  Windowed cache
    (gemma3 local layers): shift-left ring of size S, the new token in
    the last slot.
    """
    b = x.shape[0]
    S = cache_k.shape[2]
    dev = x.device
    q, k, v = _project_qkv(p, x, cfg, compute_dtype)  # (b, h, 1, dh)
    pos_t = torch.as_tensor(pos, device=dev)
    pos_vec = torch.broadcast_to(pos_t.reshape(-1), (b,)).to(torch.int32)
    posv = pos_vec[:, None, None]
    if theta is not None:
        q = L.rope(q, posv, theta)
        k = L.rope(k, posv, theta)
    act = (torch.ones(b, dtype=torch.bool, device=dev) if active is None
           else active.to(dev))

    slots = torch.arange(S, device=dev)
    if windowed_cache:
        new_k = torch.roll(cache_k, -1, dims=2)
        new_v = torch.roll(cache_v, -1, dims=2)
        new_k[:, :, S - 1] = k[:, :, 0]
        new_v[:, :, S - 1] = v[:, :, 0]
        # slot j holds absolute position pos - (S-1-j)
        k_pos = pos_vec[:, None] - (S - 1 - slots)[None, :]
        valid = k_pos >= 0
    else:
        if pos_t.dim() == 0:
            # batch-synchronous decode: every row writes the same slot
            write = (slots == pos_t.clamp(0, S - 1))[None, :].expand(b, S)
        else:
            write = slots[None, :] == pos_vec[:, None].to(slots.dtype)
        sel_w = write[:, None, :, None]
        new_k = torch.where(sel_w, k, cache_k)
        new_v = torch.where(sel_w, v, cache_v)
        k_pos = slots[None, :].expand(b, S)
        valid = k_pos <= pos_vec[:, None]
        if window is not None:
            valid &= (pos_vec[:, None] - k_pos) < window
    sel = act[:, None, None, None]
    cache_k = torch.where(sel, new_k, cache_k)
    cache_v = torch.where(sel, new_v, cache_v)

    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)
    hq, hkv, dh = q.shape[1], cache_k.shape[1], cache_k.shape[-1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.to(torch.float32),
                     cache_k.to(torch.float32)) * scale
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", pr.to(cache_v.dtype), cache_v)
    out = out.reshape(b, 1, hq, dh).transpose(1, 2)
    y = _out_proj(out, p["wo"], compute_dtype)
    return y, cache_k, cache_v
