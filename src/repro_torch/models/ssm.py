"""Mamba-2 mixer: chunked SSD (state-space duality) + O(1) decode.

Mirror of ``repro.models.ssm``.  Prefill runs the SSD block
decomposition: within a chunk the recurrence is its masked-attention
dual (an (L, L) decay-weighted C·Bᵀ product), across chunks a (b, H, N,
P) f32 state is carried by a Python loop over the chunks, the plain
counterpart of the reference's ``lax.scan``.  Decode keeps the recurrent
form: one (N, P) state update per head and token.  ``ssd_ref``, the
sequential recurrence, is the tests' oracle.

ngroups = 1 (B and C shared across heads), headdim P = cfg.ssm_head_dim,
inner width Di = expand * d_model, H = Di / P heads.  Dtypes follow the
reference: the projections, the conv and its history in the compute
dtype; dt, A, D and the state in f32 (in decode the conv's output stays
f32); the gated output ``y * silu(z)`` rounded to the compute dtype
before the norm.

One deliberate difference: the intra-chunk gate masks the upper
triangle *before* its ``exp`` (the reference takes ``exp`` of every pair
and masks after).  Above the diagonal the exponent is positive and can
overflow to ``inf`` at a full chunk of 256; the selected values are the
same, but an ``inf`` in the discarded branch would make torch's gradient
NaN.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L

f32 = torch.float32


def init_mamba2(gen: torch.Generator, cfg, dtype=torch.float32):
    E, Di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    return L.declare(gen, {
        # order: [z(Di) | x(Di) | B(N) | C(N) | dt(H)]
        "w_in": ((E, 2 * Di + 2 * N + H), L.fan_in_std(E)),
        "conv_w": ((Di + 2 * N, K), L.fan_in_std(K)),
        "conv_b": ((Di + 2 * N,), 0.0),
        "dt_bias": ((H,), 0.0),
        "A_log": ((H,), -0.5),   # constant 0.5: A = -exp(0.5)
        "D": ((H,), -1.0),       # constant 1.0
        "norm": ((Di,), 0.0),
        "w_out": ((Di, E), L.fan_in_std(Di)),
    }, dtype)


def _split_proj(p, u, cfg, compute_dtype):
    Di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = u @ p["w_in"].to(compute_dtype)
    return (zxbcdt[..., :Di], zxbcdt[..., Di:2 * Di + 2 * N],
            zxbcdt[..., 2 * Di + 2 * N:])


def _causal_conv(p, xbc: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Depthwise causal conv, kernel K, over (b, s, ch): the reference's
    sum of K shifted products, in its order and dtype."""
    K = p["conv_w"].shape[1]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    w = p["conv_w"].to(compute_dtype)
    out = pad[:, 0:s, :] * w[:, 0]
    for i in range(1, K):
        out = out + pad[:, i:i + s, :] * w[:, i]
    return F.silu((out + p["conv_b"].to(compute_dtype)).to(f32)) \
        .to(compute_dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD over full sequences.

    x: (b, s, H, P); dt: (b, s, H); A: (H,) negative; B, C: (b, s, N).
    ``s`` is padded to a multiple of ``chunk``.  Returns y: (b, s, H, P)
    f32 and the final state (b, H, N, P) f32.
    """
    b, s, H, P = x.shape
    N = B.shape[-1]
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(b, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(b, nc, chunk, H).to(f32)
    Bc = B.reshape(b, nc, chunk, N).to(f32)
    Cc = C.reshape(b, nc, chunk, N).to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    S = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xi, dti, Bi, Ci = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dti * A[None, None, :], dim=1)   # (b, L, H)
        dtx = xi * dti[..., None]                           # (b, L, H, P)
        # intra-chunk (dual / attention-like) term, masked before exp
        sc = torch.einsum("bin,bjn->bij", Ci, Bi)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (b, L, L, H)
        gate = torch.exp(diff.masked_fill(~tri, float("-inf")))
        w = (sc[..., None] * gate).permute(0, 3, 1, 2)      # (b, H, L, L)
        y_intra = (w @ dtx.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        y_inter = torch.einsum("bin,bhnp->bihp", Ci, S) \
            * torch.exp(cum)[..., None]
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)      # (b, L, H)
        S = S * torch.exp(cum[:, -1, :])[..., None, None] + torch.einsum(
            "bjn,bjhp->bhnp", Bi, dtx * decay_to_end[..., None])
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s + pad, H, P)[:, :s]
    return y, S


def ssd_ref(x, dt, A, B, C):
    """Sequential recurrence oracle: S_t = exp(A dt_t) S + dt_t B_t xᵀ_t,
    y_t = C_t S_t."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    x, dt, B, C = (t.to(f32) for t in (x, dt, B, C))
    S = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None])                # (b, H)
        S = S * decay[..., None, None] + torch.einsum(
            "bn,bhp,bh->bhnp", B[:, t], x[:, t], dt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    return torch.stack(ys, dim=1), S


def _gate_out(p, y, z, cfg, compute_dtype):
    """``y * silu(z)`` in the compute dtype, normed, projected out."""
    y = y.to(compute_dtype) * F.silu(z.to(f32)).to(compute_dtype)
    y = L.rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(compute_dtype)


def mamba2_block(p, u: torch.Tensor, cfg, compute_dtype,
                 chunk: int = 256) -> torch.Tensor:
    """Full mixer: u (b, s, E) -> (b, s, E)."""
    Di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    b, s, _ = u.shape
    z, xbc, dt = _split_proj(p, u, cfg, compute_dtype)
    xbc = _causal_conv(p, xbc, compute_dtype)
    x = xbc[..., :Di].reshape(b, s, H, P)
    B = xbc[..., Di:Di + N]
    C = xbc[..., Di + N:]
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    y, _ = ssd_chunked(x, dt, A, B, C, chunk=min(chunk, s))
    y = y + p["D"].to(f32)[None, None, :, None] * x.to(f32)
    return _gate_out(p, y.reshape(b, s, Di), z, cfg, compute_dtype)


# --------------------------------------------------------------------- #
# decode path: O(1) state update per token
# --------------------------------------------------------------------- #
def init_ssm_cache(cfg, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """``state`` (batch, H, N, P) f32 and the conv history ``conv``
    (batch, K - 1, Di + 2N) in ``dtype``, zeros."""
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    return {
        "state": torch.zeros((batch, H, N, P), dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * N), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p, u: torch.Tensor, cache: Dict[str, torch.Tensor], cfg,
                  compute_dtype, active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (b, 1, E); cache: {'state', 'conv'} -> (y, new cache).
    ``active``: optional (b,) bool; an inactive row keeps its state and
    its conv history.  The inputs are not modified."""
    Di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    b = u.shape[0]
    z, xbc, dt = _split_proj(p, u, cfg, compute_dtype)     # (b, 1, .)
    hist = torch.cat([cache["conv"], xbc], dim=1)          # (b, K, ch)
    conv_out = torch.einsum("bkc,ck->bc", hist,
                            p["conv_w"].to(compute_dtype))
    conv_out = F.silu((conv_out + p["conv_b"].to(compute_dtype)).to(f32))
    x = conv_out[:, :Di].reshape(b, H, P)
    B = conv_out[:, Di:Di + N]
    C = conv_out[:, Di + N:]
    dts = F.softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))  # (b, H)
    A = -torch.exp(p["A_log"].to(f32))
    decay = torch.exp(dts * A[None])
    S = cache["state"] * decay[..., None, None] + torch.einsum(
        "bn,bhp,bh->bhnp", B, x, dts)
    y = torch.einsum("bn,bhnp->bhp", C, S)
    y = y + p["D"].to(f32)[None, :, None] * x
    out = _gate_out(p, y.reshape(b, 1, Di), z, cfg, compute_dtype)
    new_state, new_conv = S, hist[:, 1:]
    if active is not None:
        act = active.to(u.device)
        new_state = torch.where(act[:, None, None, None], new_state,
                                cache["state"])
        new_conv = torch.where(act[:, None, None], new_conv, cache["conv"])
    return out, {"state": new_state, "conv": new_conv}
