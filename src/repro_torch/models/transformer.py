"""Decoder-only LM covering the dense / MoE / SSM / hybrid / VLM families.

Mirror of ``repro.models.transformer``.  The reference scans a stacked
layer tree under ``jax.checkpoint``; here the layers are a list of
per-layer dicts and both the full-sequence forward and decode are Python
loops over it, with per-layer (theta, window) from
:func:`_layer_meta_py` — so Gemma-3's 5:1 local:global pattern gives
each layer its own window and RoPE theta, and window layers get
window-sized decode caches.

Families (``cfg.family``):

* ``dense`` and ``vlm``: attention + SwiGLU MLP; a vlm's ``patches``
  (b, n_patches, d_vision) pass through ``vision_proj`` and prefix the
  text, and the loss drops the prefix's logits.
* ``moe``: attention + :mod:`.moe`'s top-k block, whose load-balance
  ``aux`` is summed over the layers.
* ``ssm``: the Mamba-2 mixer of :mod:`.ssm` alone.
* ``hybrid``: attention and Mamba-2 on the same normed input, combined
  as ``0.5 * (rms(att) + rms(ssm))``, then the SwiGLU MLP.

Each full-sequence attention launches the flash-attention kernel once
(on the card): once per layer for dense, vlm, moe and hybrid, never for
ssm.  Decode attends in plain torch and steps the SSM recurrence.

Training: :func:`lm_loss` is the reference's mean next-token cross
entropy (vocabulary padding masked, labels < 0 ignored) plus ``0.01 *
aux``.  When gradients are being taken and ``cfg.remat`` is set, each
layer runs under ``torch.utils.checkpoint.checkpoint(use_reentrant=
False)``, as the reference runs its layer scan under ``jax.checkpoint``:
the backward recomputes the layer, so the flash kernel launches twice
per attention layer and step.  Prefill and decode take no gradient.
On a mesh (``lm_loss(..., mesh)``) the loss is the same global mean on
every rank (:func:`_ce` reduces over the batch's and the vocabulary's
axes), and the recompute re-runs each body's collectives in the same
order on every rank.

A family the reference does not know raises ``ValueError``, as its
``_layer_fwd`` does.

``mesh=`` (a ``DeviceMesh``) runs the same functions on parameters and
caches placed by their logical axes (``models.registry.shard_params``,
``init_decode_state(..., mesh=)``), with the reference's activation
constraints as ``redistribute`` calls: the embedding's output
``("batch", None, "act_mlp")`` then the residual stream ``("batch",
seq, "act_embed")`` (batch over the data ranks, whole over ``model``),
decode's ``(None, None, "act_decode_embed")`` (every row, the embed dim
over ``data``: weight-stationary decode), logits ``("batch", None,
"act_vocab")``.  moe layers take :func:`.moe.moe_block`'s
expert-parallel branch.  ``init_lm(cfg, None)`` and :func:`decode_axes`
give the logical axes of the parameters and the caches (the reference's
second return values, without its ``layers`` axis: the port's layers are
a list).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding import shard_activation
from ..sharding.axes import zeros as mesh_zeros
from ..sharding.collectives import Local
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S

#: the families this module builds (``audio`` is :mod:`.encdec`'s)
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
ATTN_FAMILIES = ("dense", "vlm", "moe", "hybrid")
SSM_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def _norm(gen, cfg, dtype):
    return L.declare(gen, {"w": ((cfg.d_model,), ("embed_r",), 0.0)}, dtype)


def _init_layer(gen: torch.Generator, cfg, dtype) -> Dict[str, Any]:
    fam = cfg.family
    p: Dict[str, Any] = {}
    if fam in ATTN_FAMILIES:
        p["attn"] = A.init_attention(gen, cfg, dtype)
        p["ln_attn"] = _norm(gen, cfg, dtype)
    if fam in ("dense", "vlm", "hybrid"):
        p["mlp"] = L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype)
        p["ln_mlp"] = _norm(gen, cfg, dtype)
    if fam == "moe":
        p["moe"] = M.init_moe(gen, cfg, dtype)
        p["ln_mlp"] = _norm(gen, cfg, dtype)
    if fam in SSM_FAMILIES:
        p["ssm"] = S.init_mamba2(gen, cfg, dtype)
        p["ln_ssm"] = _norm(gen, cfg, dtype)
    if fam == "hybrid":
        p["comb"] = L.declare(gen, {
            "norm_attn": ((cfg.d_model,), ("embed_r",), 0.0),
            "norm_ssm": ((cfg.d_model,), ("embed_r",), 0.0)}, dtype)
    return p


def _layer_meta_py(cfg, i: int) -> Dict[str, Any]:
    """Layer ``i``'s RoPE theta and window (None = full attention)."""
    theta, window = cfg.rope_theta, cfg.window
    if cfg.local_global_pattern is not None:
        loc, glob = cfg.local_global_pattern
        is_global = (i % (loc + glob)) == (loc + glob - 1)
        window = None if is_global else cfg.window
        if is_global and cfg.rope_theta_global is not None:
            theta = cfg.rope_theta_global
    return {"theta": theta, "window": window}


def layer_metadata(cfg) -> Dict[str, List[Any]]:
    """Per-layer ``theta`` and ``window`` lists (the reference's arrays,
    with its ``-1`` as None)."""
    metas = [_layer_meta_py(cfg, i) for i in range(cfg.n_layers)]
    return {"theta": [m["theta"] for m in metas],
            "window": [m["window"] for m in metas]}


def init_lm(cfg, gen: Optional[torch.Generator]) -> Dict[str, Any]:
    """Parameters in ``cfg.param_dtype`` on ``gen``'s device: the
    reference's shapes and init stds, drawn from ``gen``; ``gen=None``:
    their logical axes."""
    _check_family(cfg)
    dtype = L.dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "layers": [_init_layer(gen, cfg, dtype)
                   for _ in range(cfg.n_layers)],
        "ln_f": _norm(gen, cfg, dtype),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.init_lm_head(gen, cfg.d_model, cfg.padded_vocab,
                                        dtype)
    if cfg.family == "vlm":
        params["vision_proj"] = L.declare(gen, {
            "w": ((cfg.d_vision, cfg.d_model), (None, "act_mlp"),
                  L.fan_in_std(cfg.d_vision)),
        }, dtype)
    return params


# --------------------------------------------------------------------- #
# full-sequence forward (prefill)
# --------------------------------------------------------------------- #
def _layer_fwd(lp, x, cfg, meta, compute_dtype, mesh=None):
    """One layer of the full sequence -> (x, its MoE aux, 0 elsewhere)."""
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam == "ssm":
        h = L.rms_norm(x, lp["ln_ssm"]["w"], cfg.norm_eps)
        return x + S.mamba2_block(lp["ssm"], h, cfg, compute_dtype), aux
    h = L.rms_norm(x, lp["ln_attn"]["w"], cfg.norm_eps)
    att = A.attention_block(lp["attn"], h, cfg, theta=meta["theta"],
                            window=meta["window"],
                            compute_dtype=compute_dtype)
    if fam == "hybrid":
        ssm = S.mamba2_block(lp["ssm"], h, cfg, compute_dtype)
        x = x + 0.5 * (
            L.rms_norm(att, lp["comb"]["norm_attn"], cfg.norm_eps)
            + L.rms_norm(ssm, lp["comb"]["norm_ssm"], cfg.norm_eps))
    else:
        x = x + att
    h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
    if fam == "moe":
        y, aux = M.moe_block(lp["moe"], h, cfg, compute_dtype, mesh)
        return x + y, aux
    return x + L.swiglu(lp["mlp"], h, compute_dtype), aux


def _takes_grad(lp, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in _tensors(lp)))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _residual(x, cfg, mesh):
    seq_ax = "act_seq" if cfg.seq_shard_activations else None
    return shard_activation(x, ("batch", seq_ax, "act_embed"), mesh)


def _vision_prefix(params, patches, x, compute_dtype, mesh):
    """``patches @ vision_proj`` before the text; on a mesh both are laid
    out as the embedding's output (``vision_proj`` is ``act_mlp``)."""
    patches = shard_activation(patches, ("batch", None, None), mesh)
    w = params["vision_proj"]["w"].to(compute_dtype)
    y = L.on_shards(lambda wl, pl, xl: torch.cat(
        [pl.to(compute_dtype) @ wl, xl], dim=1), L.placements_of(x), w,
        patches, x)
    return y, patches.shape[1]


def lm_forward(params, cfg, tokens: torch.Tensor,
               patches: Optional[torch.Tensor] = None, mesh=None):
    """tokens (b, s) int [, a vlm's patches (b, n_patches, d_vision)] ->
    (logits (b, n_prefix + s, padded_vocab) in ``cfg.dtype``, the summed
    MoE aux (f32 0-d), n_prefix).  On a mesh the logits are a DTensor
    sharded as ``("batch", None, "act_vocab")``."""
    _check_family(cfg)
    compute_dtype = L.dtype_of(cfg.dtype)
    x = L.embed(params["embed"], tokens, compute_dtype, mesh)
    n_prefix = 0
    if cfg.family == "vlm" and patches is not None:
        x, n_prefix = _vision_prefix(params, patches, x, compute_dtype,
                                     mesh)
    x = shard_activation(x, ("batch", None, "act_embed"), mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        meta = _layer_meta_py(cfg, i)
        if cfg.remat and _takes_grad(lp, x):
            x, a = checkpoint(_layer_fwd, lp, x, cfg, meta, compute_dtype,
                              mesh, use_reentrant=False)
        else:
            x, a = _layer_fwd(lp, x, cfg, meta, compute_dtype, mesh)
        aux = aux + a
        x = _residual(x, cfg, mesh)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
    return _head(params, cfg, x, compute_dtype), aux, n_prefix


def _head(params, cfg, x, compute_dtype):
    if cfg.tie_embeddings:
        return L.head(params["embed"]["table"], x, compute_dtype, tied=True)
    return L.lm_head(params["head"], x, compute_dtype)


def first_position(logits):
    """``logits[:, 0]``: (b, 1, V) -> (b, V), a DTensor's on its local
    shards."""
    if not L.is_dtensor(logits):
        return logits[:, 0]
    from torch.distributed.tensor import Shard

    out = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
           for p in logits.placements]
    return L.lmap(lambda t: t[:, 0], out, (logits.placements,),
                  logits.device_mesh)(logits)


def lm_loss(params, cfg, batch, mesh=None):
    """Mean next-token CE over valid (label >= 0) text positions + 0.01 *
    MoE aux -> (loss, {"ce", "aux", "tokens"}), f32 0-d tensors (plain
    tensors, the same on every rank of a mesh: the CE over the global
    batch's valid tokens)."""
    logits, aux, n_prefix = lm_forward(params, cfg, batch["tokens"],
                                       batch.get("patches"), mesh)
    ce, denom = _ce(logits, batch["labels"], cfg, n_prefix)
    loss = ce / denom + 0.01 * aux
    return loss, {"ce": ce / denom, "aux": aux, "tokens": denom}


def _ce(logits, labels, cfg, n_prefix: int = 0):
    """(summed CE, valid-label count) in f32 over the positions from
    ``n_prefix`` on: the padded vocabulary's logits masked to -1e30,
    each label's logit picked (0 for a label past the padded vocabulary,
    as the reference's one-hot picks).  On a mesh (DTensor logits laid
    out as ``("batch", None, "act_vocab")``) each rank takes its rows and
    vocabulary slice: the log-sum-exp's max and sum and the picked logit
    are reduced over the vocabulary's axes, the CE and the count over the
    batch's, and both come back as plain tensors, the same on every
    rank."""
    if not L.is_dtensor(logits):
        return _ce_local(logits, labels, cfg, n_prefix, Local(None), (),
                         ())
    from torch.distributed.tensor import Replicate

    mesh = logits.device_mesh
    labels = shard_activation(labels, ("batch", None), mesh)
    loc = Local(mesh)
    v_axes, b_axes = L.sharded_axes(logits, 2), L.sharded_axes(logits, 0)
    whole = [Replicate()] * mesh.ndim
    ce, denom = L.on_shards(
        lambda lg, lb: _ce_local(lg, lb, cfg, n_prefix, loc, v_axes,
                                 b_axes), (whole, whole), logits, labels)
    return ce.to_local(), denom.to_local()


def _ce_local(logits, labels, cfg, n_prefix, loc: Local, v_axes, b_axes):
    """:func:`_ce` on one rank's rows and vocabulary slice (the whole of
    both off a mesh).  Every reduction's result is the same on every
    rank, which goes on with it whole (the identity backward)."""
    if n_prefix:
        logits = logits[:, n_prefix:]
    logits = logits.float()
    vl = logits.shape[-1]
    v0 = loc.rank(v_axes) * vl
    vp = vl * loc.size(v_axes)
    if vp > cfg.vocab_size:
        iota = torch.arange(v0, v0 + vl, device=logits.device)
        logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
    if v_axes:
        m = loc.all_reduce(logits.detach().amax(-1, keepdim=True), v_axes,
                           "max")
        lse = torch.log(loc.all_reduce(torch.exp(logits - m).sum(-1),
                                       v_axes)) + m[..., 0]
    else:
        lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    at = labels - v0
    inside = (labels >= 0) & (labels < vp) & (at >= 0) & (at < vl)
    picked = loc.all_reduce(torch.where(
        inside, logits.gather(-1, at.clamp(0, vl - 1)[..., None])[..., 0],
        0.0), v_axes)
    valid = labels >= 0
    ce = loc.all_reduce(torch.sum(torch.where(valid, lse - picked, 0.0)),
                        b_axes)
    denom = torch.clamp(loc.all_reduce(torch.sum(valid), b_axes),
                        min=1).to(torch.float32)
    return ce, denom


# --------------------------------------------------------------------- #
# decode: per-layer loop with per-layer cache shapes
# --------------------------------------------------------------------- #
KV_AXES = ("cache_batch", "kv_heads", "cache_seq", "head_dim")


def decode_axes(cfg) -> List[Dict[str, Any]]:
    """The logical axes of :func:`init_decode_state`'s caches."""
    _check_family(cfg)
    out = []
    for _ in range(cfg.n_layers):
        a: Dict[str, Any] = {}
        if cfg.family in ATTN_FAMILIES:
            a["k"] = a["v"] = KV_AXES
        if cfg.family in SSM_FAMILIES:
            a["ssm"] = S.SSM_CACHE_AXES
        out.append(a)
    return out


def init_decode_state(cfg, batch: int, kv_len: int, device,
                      mesh=None) -> List[Dict[str, Any]]:
    """Per-layer caches: attention families ``{"k", "v"}`` of (batch,
    hkv, S_i, dh) in ``cfg.dtype``, window layers with ``S_i =
    min(window, kv_len)``; ssm and hybrid ``{"ssm": {"state", "conv"}}``
    (:func:`.ssm.init_ssm_cache`).  On a mesh, DTensors laid out by
    :func:`decode_axes`, each rank allocating its block."""
    _check_family(cfg)
    dtype = L.dtype_of(cfg.dtype)
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(shape, axes, dt=dtype):
        if mesh is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return mesh_zeros(shape, axes, mesh, dtype=dt, device=device)

    caches: List[Dict[str, Any]] = []
    for i in range(cfg.n_layers):
        c: Dict[str, Any] = {}
        if cfg.family in ATTN_FAMILIES:
            window = _layer_meta_py(cfg, i)["window"]
            S_i = kv_len if window is None else min(window, kv_len)
            shape = (batch, Hkv, S_i, Dh)
            c["k"] = zeros(shape, KV_AXES)
            c["v"] = zeros(shape, KV_AXES)
        if cfg.family in SSM_FAMILIES:
            c["ssm"] = S.init_ssm_cache(cfg, batch, dtype, device,
                                        zeros=zeros)
        caches.append(c)
    return caches


def lm_decode_step(params, cfg, caches, token: torch.Tensor, pos,
                   active: Optional[torch.Tensor] = None, mesh=None):
    """token: (b, 1) int; pos: scalar or (b,) int; active: optional (b,)
    bool (continuous batching) -> (logits (b, vp), new caches).  On a
    mesh the logits are a DTensor sharded as ``("batch", "act_vocab")``
    and the caches keep their placements."""
    _check_family(cfg)
    compute_dtype = L.dtype_of(cfg.dtype)
    fam = cfg.family
    x = L.embed(params["embed"], token, compute_dtype, mesh)
    # weight-stationary decode: the activations carry the data shard of
    # the embed dim, so each layer contracts against its local weight
    # shard (partial sums reduced) instead of gathering the weights
    act_ax = (None, None, "act_decode_embed")
    x = shard_activation(x, act_ax, mesh)
    new_caches = []
    for i, lp in enumerate(params["layers"]):
        meta = _layer_meta_py(cfg, i)
        c = dict(caches[i])
        if fam == "ssm":
            h = L.rms_norm(x, lp["ln_ssm"]["w"], cfg.norm_eps)
            y, c["ssm"] = S.mamba2_decode(lp["ssm"], h, c["ssm"], cfg,
                                          compute_dtype, active=active)
            x = shard_activation(x + y, act_ax, mesh)
            new_caches.append(c)
            continue
        h = L.rms_norm(x, lp["ln_attn"]["w"], cfg.norm_eps)
        windowed = (meta["window"] is not None
                    and c["k"].shape[2] <= meta["window"])
        att, c["k"], c["v"] = A.decode_attention_block(
            lp["attn"], h, c["k"], c["v"], pos, cfg,
            theta=meta["theta"], window=meta["window"],
            compute_dtype=compute_dtype, windowed_cache=windowed,
            active=active)
        if fam == "hybrid":
            ssm, c["ssm"] = S.mamba2_decode(lp["ssm"], h, c["ssm"], cfg,
                                            compute_dtype, active=active)
            x = x + 0.5 * (
                L.rms_norm(att, lp["comb"]["norm_attn"], cfg.norm_eps)
                + L.rms_norm(ssm, lp["comb"]["norm_ssm"], cfg.norm_eps))
        else:
            x = x + att
        h = L.rms_norm(x, lp["ln_mlp"]["w"], cfg.norm_eps)
        if fam == "moe":
            x = x + M.moe_block(lp["moe"], h, cfg, compute_dtype, mesh)[0]
        else:
            x = x + L.swiglu(lp["mlp"], h, compute_dtype)
        x = shard_activation(x, act_ax, mesh)
        new_caches.append(c)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
    logits = first_position(_head(params, cfg, x, compute_dtype))
    return logits, new_caches
