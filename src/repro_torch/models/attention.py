"""GQA attention block: full-sequence (prefill) path + decode path.

Mirror of ``repro.models.attention``.  The full-sequence block calls
:func:`repro_torch.kernels.ops.attention`, which launches the
hand-written flash-attention kernel on the card (the plain version on
the CPU): the slot the reference reserves for its Pallas kernel, where
it runs the plain ``chunked_attention``.  Both compute the same
function: GQA, causal mask, sliding window, f32 scores.  The decode path
attends one token against the KV cache in plain torch, as the reference
does in jnp.

Each block has one body.  Off a mesh it runs on the plain tensors; under
a ``DeviceMesh`` (DTensor activations and parameters) it runs on local
shards through ``local_map``, the q / k / v and output constraints of
the reference (``("batch", "heads")`` / ``("batch", "kv_heads")``) being
the placements it reads:

* prefill: a sequence-sharded input (``act_seq``) is gathered first,
  the projections are gathered over ``data`` (ZeRO-3), each
  rank projects its local q and kv heads and hands the flash kernel its
  q heads and the kv heads they read (globally ``q_head // group``: a
  slice when the groups align with the shards, else a per-head index —
  q heads sharded while the kv heads are whole), and the output
  projection's partial sums are reduced over ``model`` once;
* decode: against an embed-sharded input (``act_decode_embed``) the
  projections contract shard-local and reduce over ``data``; the cache
  ``("cache_batch", "kv_heads", "cache_seq", "head_dim")`` is written
  where it lies (each rank its rows and, sequence-sharded, its slots);
  a sequence-sharded cache (``cache_seq -> model`` when the kv heads do
  not divide the axis) is attended with a split softmax: per shard a max,
  a sum and weighted values, reduced over ``model`` — the cache itself is
  never gathered.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..sharding.collectives import Local
from . import layers as L

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32):
    E = cfg.d_model
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    std = L.fan_in_std(E)
    decls = {
        "wq": ((E, Hq, Dh), ("embed", "heads", "head_dim"), std),
        "wk": ((E, Hkv, Dh), ("embed", "kv_heads", "head_dim"), std),
        "wv": ((E, Hkv, Dh), ("embed", "kv_heads", "head_dim"), std),
        "wo": ((Hq, Dh, E), ("heads", "head_dim", "embed"),
               L.fan_in_std(Hq * Dh)),
    }
    if cfg.qkv_bias:
        decls.update({
            "bq": ((Hq, Dh), ("heads", "head_dim"), 0.0),
            "bk": ((Hkv, Dh), ("kv_heads", "head_dim"), 0.0),
            "bv": ((Hkv, Dh), ("kv_heads", "head_dim"), 0.0),
        })
    return L.declare(gen, decls, dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """einsum('bse,ehd->bhsd') as one matmul: (b, s, E) -> (b, h, s, d)."""
    E, H, D = w.shape
    b, s, _ = x.shape
    y = x @ w.to(compute_dtype).reshape(E, H * D)
    return y.view(b, s, H, D).transpose(1, 2)


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """einsum('bhsd,hde->bse')."""
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d) \
        @ wo.to(compute_dtype).reshape(h * d, -1)


_W = ("wq", "wk", "wv", "wo")
_B = ("bq", "bk", "bv")


def kv_for_local_q(k, v, q_axes, kv_axes, n_heads: int, n_kv: int,
                   loc: Local):
    """The kv heads (dim 1) this rank's q heads read: all of them when
    the q and kv heads are split alike (or not at all); when only the q
    heads are split, the kv heads ``q_head // group`` of the local q
    heads — a slice when the local q heads cover whole groups, else one
    kv head per q head (so the kernel's group is 1)."""
    if tuple(q_axes) == tuple(kv_axes):
        return k, v
    if kv_axes:
        raise ValueError("kv heads split over an axis the q heads are not")
    n = n_heads // loc.size(q_axes)
    a = loc.rank(q_axes) * n
    g = n_heads // n_kv
    if n % g == 0 and a % g == 0:
        sl = slice(a // g, (a + n) // g)
        return k[:, sl], v[:, sl]
    idx = torch.div(torch.arange(a, a + n, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(1, idx), v.index_select(1, idx)


def _params(p, x, compute_dtype):
    """The projections as a body over ``x`` reads them
    (:func:`.layers.mesh_weights`) and the biases, in the compute
    dtype."""
    ws = L.mesh_weights(x, [p[n] for n in _W], compute_dtype)
    bs = [p[n].to(compute_dtype) for n in _B if n in p]
    return ws, bs


def _qkv_local(xl, wl, bl, compute_dtype, loc, e_axes):
    q, k, v = (loc.all_reduce(_proj(xl, w, compute_dtype), e_axes)
               for w in wl[:3])
    if bl:
        q, k, v = (t + b[None, :, None, :] for t, b in zip((q, k, v), bl))
    return q, k, v


def attention_block(p: Dict[str, Any], x: torch.Tensor, cfg, *, theta,
                    window: Optional[int], compute_dtype,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence (prefill) attention block: x (b, s, E) -> (b, s,
    E); ``window`` None = full attention (the reference's traced
    ``-1``), ``causal=False`` for an encoder; ``theta`` None = no RoPE.
    On a mesh x is batch-sharded, a sequence-sharded stream gathered
    first (:func:`.layers.whole_seq`), its embed dim whole; the output
    takes x's placements."""
    xin = L.whole_seq(x)
    if L.sharded_axes(xin, 2):
        raise ValueError("a full-sequence block takes an input whole on "
                         "its embed dim")
    loc = Local.of(xin)
    ws, bs = _params(p, xin, compute_dtype)
    q_axes, kv_axes = L.sharded_axes(ws[0], 1), L.sharded_axes(ws[1], 1)

    def body(xl, *wl):
        q, k, v = _qkv_local(xl, wl[:4], wl[4:], compute_dtype, loc, ())
        if theta is not None:
            positions = torch.arange(xl.shape[1], device=xl.device)[
                None, None, :]
            q = L.rope(q, positions, theta)
            k = L.rope(k, positions, theta)
        k, v = kv_for_local_q(k, v, q_axes, kv_axes, cfg.n_heads,
                              cfg.n_kv_heads, loc)
        out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window)
        return loc.all_reduce(_out_proj(out, wl[3], compute_dtype), q_axes)

    y = L.on_shards(body, L.placements_of(xin), xin, *ws, *bs)
    return L.with_placements(y, L.placements_of(x))


# --------------------------------------------------------------------- #
# decode path
# --------------------------------------------------------------------- #
def attend_cache(q, ck, cv, valid, *, q_axes, kv_axes, seq_axes,
                 n_heads: int, n_kv: int, loc: Local, scale: float):
    """One query token per row against a cache block, on local shards.
    q (b, hq_local, dh); ck / cv (b, hkv_local, S_local, dh); valid (b,
    S_local) bool -> (b, hq_local, dh) in the cache's dtype.

    A sequence-sharded cache (``seq_axes``; its kv heads then whole)
    takes every q head and combines the shards' softmax partials — the
    max, the sum of exponentials and the weighted values, each reduced
    over ``seq_axes`` — then keeps the local q heads.  Otherwise the
    reference's formula on the local heads."""
    b, dh = q.shape[0], q.shape[-1]
    if seq_axes:
        qa = loc.all_gather(q, q_axes, dim=1)
        g = n_heads // n_kv
        s = torch.einsum("bhgd,bhkd->bhgk",
                         qa.reshape(b, n_kv, g, dh).to(torch.float32),
                         ck.to(torch.float32)) * scale
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
        m = loc.all_reduce(s.amax(-1, keepdim=True), seq_axes, "max")
        e = torch.exp(s - m)
        den = loc.all_reduce(e.sum(-1, keepdim=True), seq_axes)
        num = loc.all_reduce(torch.einsum("bhgk,bhkd->bhgd", e,
                                          cv.to(torch.float32)), seq_axes)
        out = (num / den).reshape(b, n_heads, dh).to(cv.dtype)
        n = q.shape[1]
        r = loc.rank(q_axes)
        return out[:, r * n:(r + 1) * n]
    ck, cv = kv_for_local_q(ck, cv, q_axes, kv_axes, n_heads, n_kv, loc)
    hq, hkv = q.shape[1], ck.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.to(torch.float32),
                     ck.to(torch.float32)) * scale
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", pr.to(cv.dtype), cv)
    return out.reshape(b, hq, dh)


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

    On a mesh x holds every row, its embed dim sharded over ``data`` or
    whole, and the caches lie as they are laid out: each rank projects
    every row (partial sums over an embed shard reduced once), writes
    and attends its cache rows and slots, gathers the rows' outputs over
    the batch shards and projects out its q heads' share (reduced over
    ``model``).
    """
    loc = Local.of(x)
    ws, bs = _params(p, x, compute_dtype)
    e_axes = L.sharded_axes(x, 2)
    q_axes, kv_axes = L.sharded_axes(ws[0], 1), L.sharded_axes(ws[1], 1)
    b_axes, seq_axes = (L.sharded_axes(cache_k, 0),
                        L.sharded_axes(cache_k, 2))
    if L.sharded_axes(x, 0):
        raise ValueError("a decode block takes every row of the batch")
    b = x.shape[0]
    dev = L.local_device(x)
    pos_t = torch.as_tensor(pos, device=dev)
    pos_vec = torch.broadcast_to(pos_t.reshape(-1), (b,)).to(torch.int32)
    act = (torch.ones(b, dtype=torch.bool, device=dev) if active is None
           else active.to(dev))
    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)

    def body(xl, *rest):
        wl, bl = rest[:4], rest[4:-2]
        ck, cv = rest[-2:]
        q, k, v = _qkv_local(xl, wl, bl, compute_dtype, loc, e_axes)
        posv = pos_vec[:, None, None]
        if theta is not None:
            q = L.rope(q, posv, theta)
            k = L.rope(k, posv, theta)
        bc, _, s_loc, _ = ck.shape
        rows = slice(loc.rank(b_axes) * bc, (loc.rank(b_axes) + 1) * bc)
        q, k, v = q[rows], k[rows], v[rows]
        pr, ar = pos_vec[rows], act[rows]
        S = s_loc * loc.size(seq_axes)
        slots = loc.rank(seq_axes) * s_loc + torch.arange(s_loc,
                                                          device=dev)
        if windowed_cache:
            nk, nv = torch.roll(ck, -1, dims=2), torch.roll(cv, -1, dims=2)
            last_k, last_v = k[:, :, 0], v[:, :, 0]
            if seq_axes:
                # the slot past a shard's end is the next shard's first
                firsts = [loc.all_gather(c[:, :, :1], seq_axes, dim=2)
                          for c in (ck, cv)]
                r = loc.rank(seq_axes)
                if r + 1 < loc.size(seq_axes):
                    last_k, last_v = (f[:, :, r + 1] for f in firsts)
            nk[:, :, s_loc - 1] = last_k
            nv[:, :, s_loc - 1] = last_v
            valid = (pr[:, None] - (S - 1 - slots)[None, :]) >= 0
        else:
            if pos_t.dim() == 0:
                write = (slots == pos_t.clamp(0, S - 1))[None, :].expand(
                    bc, s_loc)
            else:
                write = slots[None, :] == pr[:, None].to(slots.dtype)
            sel_w = write[:, None, :, None]
            nk = torch.where(sel_w, k, ck)
            nv = torch.where(sel_w, v, cv)
            k_pos = slots[None, :].expand(bc, s_loc)
            valid = k_pos <= pr[:, None]
            if window is not None:
                valid &= (pr[:, None] - k_pos) < window
        sel = ar[:, None, None, None]
        ck, cv = torch.where(sel, nk, ck), torch.where(sel, nv, cv)
        out = attend_cache(q[:, :, 0], ck, cv, valid, q_axes=q_axes,
                           kv_axes=kv_axes, seq_axes=seq_axes,
                           n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                           loc=loc, scale=scale)
        out = loc.all_gather(out, b_axes, dim=0)[:, :, None, :]
        y = loc.all_reduce(_out_proj(out, wl[3], compute_dtype), q_axes)
        return y, ck, cv

    return L.on_shards(
        body, tuple(L.placements_of(t) for t in (x, cache_k, cache_v)),
        x, *ws, *bs, cache_k, cache_v)


