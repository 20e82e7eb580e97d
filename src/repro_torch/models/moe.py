"""Mixture-of-experts block: top-k routing with dense dispatch.

Mirror of ``repro.models.moe``'s one-device branch.  The reference's
``moe_block`` routes with ``moe_block_dense`` whenever it has no mesh
with a ``model`` axis, which on one card is always, so the port's models
call ``moe_block_dense`` itself; the expert-parallel branch
(``shard_map`` with an ``all_to_all`` over the ``model`` axis,
capacity-padded buffers) has no meaning on one card and is not ported.

Dense dispatch: every expert runs its SwiGLU FFN on every token, and the
gates (the f32 softmax's top-k scattered into zeros and renormalised
with ``+1e-9``) weight the sum, so the other experts' outputs are
multiplied by exactly 0.  The tokens go through the experts in chunks
(:func:`dispatch_chunk`) whose (X, chunk, d_ff) intermediates stay
within ``DISPATCH_BYTES``: at a 32,768-token prefill of ``dbrx-132b``
the whole batch's would hold ~67 GB.  Each token's output depends on
that token alone, so the chunks compute the same function; a smoke
config's batch is one chunk.  The port keeps this form rather than
gathering each expert's tokens: it is the reference's own function, has
no data-dependent shapes (no host sync in a decode step), and costs
``n_experts / top_k`` times the FLOPs of a top-k dispatch.  The
Shazeer-style load-balance loss ``X · Σ f·P`` is returned beside it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import layers as L

f32 = torch.float32
#: bytes of one (X, chunk, d_ff) intermediate of the dense dispatch
DISPATCH_BYTES = 1 << 30


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32):
    E, Fd, X = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = L.fan_in_std(E)
    return L.declare(gen, {
        "router": ((E, X), std),
        "w_gate": ((X, E, Fd), std),
        "w_up": ((X, E, Fd), std),
        "w_down": ((X, Fd, E), L.fan_in_std(Fd)),
    }, dtype)


def _expert_ffn(w_gate, w_up, w_down, x: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """x: (X, C, E) -> (X, C, E), expert x's SwiGLU on its rows (a weight
    already in the compute dtype is not cast again)."""
    g = torch.bmm(x, w_gate.to(compute_dtype))
    u = torch.bmm(x, w_up.to(compute_dtype))
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
