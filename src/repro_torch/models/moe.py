"""Mixture-of-experts block: top-k routing, dense dispatch off a mesh,
expert-parallel dispatch on one.

Mirror of ``repro.models.moe``.  :func:`moe_block` takes the reference's
two branches:

* Off a mesh, on a mesh without a ``model`` axis, or when the experts do
  not divide that axis: :func:`moe_block_dense`, the exact dense
  dispatch.  Every expert runs its SwiGLU FFN on every token, and the
  gates (the f32 softmax's top-k scattered into zeros and renormalised
  with ``+1e-9``) weight the sum, so the other experts' outputs are
  multiplied by exactly 0.  The tokens go through the experts in chunks
  (:func:`dispatch_chunk`) whose (X, chunk, d_ff) intermediates stay
  within ``DISPATCH_BYTES``: at a 32,768-token prefill of ``dbrx-132b``
  the whole batch's would hold ~67 GB.  Each token's output depends on
  that token alone, so the chunks compute the same function.  It has no
  data-dependent shapes (no host sync in a decode step) and costs
  ``n_experts / top_k`` times the FLOPs of a top-k dispatch.
* Expert parallel (``experts -> model``, ``ep`` the axis's extent):
  :func:`_local_dispatch_combine` under ``local_map`` with the
  reference's ``shard_map`` specs.  Each shard routes its local tokens
  (the sequence split over ``model`` when ``ep`` divides it), packs them
  into an (X, C, E) buffer with the capacity ``C = int(max(1, ceil(T k /
  X) * capacity_factor))`` of its local token count T — top-k then
  truncate, so a token past an expert's capacity is dropped and adds 0 —
  exchanges it with the expert owners by an ``all_to_all`` over
  ``model``, runs its local experts and sends the outputs back by a
  second ``all_to_all``.  For a full sequence the expert weights are
  gathered over ``data`` in the compute dtype (ZeRO-3); in decode (one
  token, the embed dim over ``data``) they stay where they are: the
  router's and the first products' partial sums are reduced over
  ``data`` (weight-stationary decode).  Each shard's dropped tokens are
  counted on its device (:func:`ep_drops`).

The Shazeer-style load-balance loss ``X · Σ f·P`` is returned beside the
output (averaged over the shards on a mesh).
"""

from __future__ import annotations

import functools

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding.axes import mesh_axis_names, placements
from ..sharding.collectives import Local
from . import layers as L

f32 = torch.float32
#: bytes of one (X, chunk, d_ff) intermediate of the dense dispatch
DISPATCH_BYTES = 1 << 30


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32):
    E, Fd, X = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = L.fan_in_std(E)
    return L.declare(gen, {
        "router": ((E, X), ("embed_r", None), std),
        "w_gate": ((X, E, Fd), ("experts", "embed", "mlp"), std),
        "w_up": ((X, E, Fd), ("experts", "embed", "mlp"), std),
        "w_down": ((X, Fd, E), ("experts", "mlp", "embed"),
                   L.fan_in_std(Fd)),
    }, dtype)


def _expert_ffn(w_gate, w_up, w_down, x: torch.Tensor,
                compute_dtype, reduce=None) -> torch.Tensor:
    """x: (X, C, E) -> (X, C, E), expert x's SwiGLU on its rows (a weight
    already in the compute dtype is not cast again).  ``reduce``: the
    all-reduce of the first products' partial sums when E is this
    shard's slice (weight-stationary decode)."""
    g = torch.bmm(x, w_gate.to(compute_dtype))
    u = torch.bmm(x, w_up.to(compute_dtype))
    if reduce is not None:
        g, u = reduce(g), reduce(u)
    h = F.silu(g.to(f32)).to(compute_dtype) * u
    return torch.bmm(h, w_down.to(compute_dtype))


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Load-balance loss: X * sum_e f_e * P_e (f = token fraction
    routed)."""
    X = n_experts
    one_hot = F.one_hot(expert_idx.long(), X).to(f32)   # (..., k, X)
    f = one_hot.sum(dim=-2).reshape(-1, X).mean(dim=0)
    p = probs.reshape(-1, X).mean(dim=0)
    return X * torch.sum(f * p)


def dispatch_chunk(cfg, compute_dtype) -> int:
    """Tokens a chunk of the dense dispatch takes: as many as keep one
    (X, chunk, d_ff) intermediate within ``DISPATCH_BYTES``."""
    per_token = cfg.n_experts * max(cfg.d_ff, cfg.d_model) \
        * torch.empty((), dtype=compute_dtype).element_size()
    return max(1, DISPATCH_BYTES // per_token)


def moe_block_dense(p, x: torch.Tensor, cfg, compute_dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, E) -> (y (b, s, E) in the compute dtype, aux f32 0-d)."""
    b, s, E = x.shape
    X = cfg.n_experts
    probs = torch.softmax(x.to(f32) @ p["router"].to(f32), dim=-1)
    vals, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = torch.zeros_like(probs).scatter(-1, idx, vals)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    w = [p[k].to(compute_dtype) for k in ("w_gate", "w_up", "w_down")]
    xt = x.reshape(b * s, E)
    gt = gates.reshape(b * s, X).to(compute_dtype)
    step = dispatch_chunk(cfg, compute_dtype)
    outs = []
    for lo in range(0, b * s, step):
        xc = xt[lo:lo + step]
        y = _expert_ffn(*w, xc[None].expand(X, *xc.shape),
                        compute_dtype)                    # (X, c, E)
        outs.append(torch.einsum("xte,tx->te", y, gt[lo:lo + step]))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(b, s, E), _aux_loss(probs, idx, X)


# --------------------------------------------------------------------- #
# expert parallel
# --------------------------------------------------------------------- #
_W = ("w_gate", "w_up", "w_down")
_DROPS: Dict[str, torch.Tensor] = {}


def ep_drops() -> int:
    """Tokens this process's expert-parallel shards dropped (past an
    expert's capacity) since :func:`reset_ep_drops`, summed over moe
    calls (one host sync)."""
    return int(sum(int(t) for t in _DROPS.values()))


def reset_ep_drops() -> None:
    _DROPS.clear()


def _count_drops(n: torch.Tensor) -> None:
    if n.device.type == "meta":
        return      # an analysed step (launch.step_analysis): no count
    key = str(n.device)
    _DROPS[key] = _DROPS[key] + n if key in _DROPS else n


def expert_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in ``[0, n)``, by a
    scatter-add: bincount has no ``meta`` kernel, so a step that calls it
    cannot be analysed (``launch.step_analysis``)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, ids, torch.ones_like(ids))


def _local_dispatch_combine(x, router, w_gate, w_up, w_down, *, cfg,
                            compute_dtype, ep: int, loc: Local,
                            dp_axes, ws_axes):
    """The body run on each shard: route the local tokens, dispatch
    them to the expert owners, combine.  ``ws_axes``: the axes the embed
    dim is split over in weight-stationary decode (else empty)."""
    b, s, E = x.shape
    X, k = cfg.n_experts, cfg.top_k
    T = b * s
    xf = x.reshape(T, E)
    if ws_axes:
        r = loc.rank(ws_axes)
        # the whole logits route this rank's embed slice: the backward
        # sums the slices' shares
        logits = loc.all_reduce(xf.to(f32) @ router[r * E:(r + 1) * E]
                                .to(f32), ws_axes, grad="sum")
    else:
        logits = xf.to(f32) @ router.to(f32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    every = tuple(dp_axes) + ("model",)
    # the mean of the shards' aux, the same on every rank (the loss's
    # term): each rank's cotangent is the whole one
    aux = loc.all_reduce(_aux_loss(probs, idx, X), every) / loc.size(every)

    e_flat = idx.reshape(-1)
    t_flat = torch.arange(T, device=x.device).repeat_interleave(k)
    w_flat = vals.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s, w_s = e_flat[order], t_flat[order], w_flat[order]
    counts = expert_counts(e_flat, X)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[e_s]
    C = int(max(1, -(-T * k // X) * cfg.capacity_factor))
    keep = pos < C
    _count_drops((~keep).sum())
    ei = torch.where(keep, e_s, 0)
    ci = torch.where(keep, pos, 0)
    buf = torch.zeros((X, C, E), dtype=compute_dtype, device=x.device)
    buf.index_put_((ei, ci), torch.where(keep[:, None], xf[t_s], 0)
                   .to(compute_dtype), accumulate=True)
    if ep > 1:
        # (X, C, E) -> (X/ep, ep C, E): tokens for my experts from all peers
        buf = loc.all_to_all(buf, "model").reshape(ep, X // ep, C, E) \
            .transpose(0, 1).reshape(X // ep, ep * C, E)
    reduce = (lambda t: loc.all_reduce(t, ws_axes)) if ws_axes else None
    h = _expert_ffn(w_gate, w_up, w_down, buf, compute_dtype, reduce)
    if ep > 1:
        h = h.reshape(X // ep, ep, C, E).transpose(0, 1)
        h = loc.all_to_all(h, "model").reshape(X, C, E)
    gathered = torch.where(keep[:, None], h[ei, ci], 0)
    y = torch.zeros((T, E), dtype=f32, device=x.device).index_add_(
        0, t_s, gathered.to(f32) * w_s[:, None])
    return y.to(compute_dtype).reshape(b, s, E), aux


def moe_block(p, x, cfg, compute_dtype, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE; dense dispatch off a mesh or when the
    experts do not divide the ``model`` axis.  -> (y like ``x``, aux f32
    0-d, a plain tensor)."""
    if mesh is None:
        return moe_block_dense(p, x, cfg, compute_dtype)
    names = mesh_axis_names(mesh)
    loc = Local(mesh)
    ep = loc.size("model")
    if "model" not in names or cfg.n_experts % ep != 0:
        return _dense_on_mesh(p, x, cfg, compute_dtype, mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    b, s, E = x.shape
    # route only the local sequence slice per model shard: with tokens
    # replicated over `model`, every shard would route (and the experts
    # compute) the same tokens ep times over
    seq_split = s % ep == 0 and s >= ep
    dsz = loc.size("data")
    fsdp = bool(L.sharded_axes(p["w_gate"], 1))
    ws = s == 1 and fsdp and E % dsz == 0 and dsz > 1
    if ws:
        x_spec = (None, None, "data")
        w = [p[n].to(compute_dtype) for n in _W]
    else:
        x_spec = (dp_axes, "model" if seq_split else None, None)
        w = [L.gather_data(p[n], compute_dtype) for n in _W]
    x_pl = placements(x_spec, mesh)
    xin = L.with_placements(x, x_pl)
    router = L.gather_all(p["router"])
    body = functools.partial(
        _local_dispatch_combine, cfg=cfg, compute_dtype=compute_dtype,
        ep=ep, loc=loc, dp_axes=dp_axes, ws_axes=("data",) if ws else ())
    from torch.distributed.tensor import Replicate

    args = (xin, router, *w)
    y, aux = L.lmap(body, (x_pl, [Replicate()] * mesh.ndim),
                    tuple(t.placements for t in args), mesh,
                    L.grad_placements(args))(*args)
    return L.with_placements(y, x.placements), aux.to_local()


def _dense_on_mesh(p, x, cfg, compute_dtype, mesh):
    """The dense dispatch on each rank's rows, every weight whole (its
    aux is the load-balance loss of those rows)."""
    from torch.distributed.tensor import Replicate, Shard

    x_pl = [p_ if isinstance(p_, Shard) and p_.dim == 0 else Replicate()
            for p_ in x.placements]
    xin = L.with_placements(x, x_pl)
    w = {n: L.gather_all(p[n]) for n in ("router",) + _W}
    args = (xin, *w.values())
    y, aux = L.lmap(
        lambda xl, *wl: moe_block_dense(dict(zip(w, wl)), xl, cfg,
                                        compute_dtype),
        (x_pl, [Replicate()] * mesh.ndim),
        tuple(t.placements for t in args), mesh,
        L.grad_placements(args))(*args)
    return L.with_placements(y, x.placements), aux.to_local()
