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

Prefill and decode share one body (:func:`_mixer`), run on the plain
tensors off a mesh.  Under a ``DeviceMesh`` it runs on local shards
(``local_map``), a sequence-sharded input gathered first:
``w_in``'s output (``ssm_inner``) is split over ``model`` in contiguous
blocks of the concatenated [z | x | B | C | dt], so its local products
are gathered over ``model``; the SSD scan (or the recurrent step) then
runs on the local heads (``ssm_heads -> model``; every head when they do
not divide the axis), the gated norm reduces its sum of squares over
``model``, and ``w_out``'s rows (``ssm_inner``) take the local heads'
channels, their partial sums reduced over ``model``.  The decode caches
lie as their axes say: ``state`` over the batch shards and the local
heads, ``conv`` over the batch shards and ``model`` on its channels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding.collectives import Local
from . import layers as L

f32 = torch.float32

#: the logical axes of :func:`init_ssm_cache`'s tensors
SSM_CACHE_AXES = {"state": ("cache_batch", "ssm_heads", "ssm_state", None),
                  "conv": ("cache_batch", "conv", "ssm_inner")}


def init_mamba2(gen: torch.Generator, cfg, dtype=torch.float32):
    E, Di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    return L.declare(gen, {
        # order: [z(Di) | x(Di) | B(N) | C(N) | dt(H)]
        "w_in": ((E, 2 * Di + 2 * N + H), ("embed", "ssm_inner"),
                 L.fan_in_std(E)),
        "conv_w": ((Di + 2 * N, K), ("ssm_inner", "conv"), L.fan_in_std(K)),
        "conv_b": ((Di + 2 * N,), ("ssm_inner",), 0.0),
        "dt_bias": ((H,), ("ssm_heads",), 0.0),
        "A_log": ((H,), ("ssm_heads",), -0.5),   # A = -exp(0.5)
        "D": ((H,), ("ssm_heads",), -1.0),       # constant 1.0
        "norm": ((Di,), ("ssm_inner",), 0.0),
        "w_out": ((Di, E), ("ssm_inner", "embed"), L.fan_in_std(Di)),
    }, dtype)


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


def mamba2_block(p, u: torch.Tensor, cfg, compute_dtype,
                 chunk: int = 256) -> torch.Tensor:
    """Full mixer: u (b, s, E) -> (b, s, E)."""
    return _mixer(p, u, cfg, compute_dtype, None, None, chunk)


# --------------------------------------------------------------------- #
# decode path: O(1) state update per token
# --------------------------------------------------------------------- #
def init_ssm_cache(cfg, batch: int, dtype, device,
                   zeros=None) -> Dict[str, torch.Tensor]:
    """``state`` (batch, H, N, P) f32 and the conv history ``conv``
    (batch, K - 1, Di + 2N) in ``dtype``, zeros; ``zeros(shape, axes,
    dtype)`` makes them when given (on a mesh)."""
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    if zeros is None:
        def zeros(shape, axes, dt):
            return torch.zeros(shape, dtype=dt, device=device)
    return {
        "state": zeros((batch, H, N, P), SSM_CACHE_AXES["state"], f32),
        "conv": zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N),
                      SSM_CACHE_AXES["conv"], dtype),
    }


def mamba2_decode(p, u: torch.Tensor, cache: Dict[str, torch.Tensor], cfg,
                  compute_dtype, active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (b, 1, E); cache: {'state', 'conv'} -> (y, new cache).
    ``active``: optional (b,) bool; an inactive row keeps its state and
    its conv history.  The inputs are not modified."""
    return _mixer(p, u, cfg, compute_dtype, cache, active, None)


# --------------------------------------------------------------------- #
# the mixer's body, on plain tensors or on local shards
# --------------------------------------------------------------------- #
def _mixer(p, u, cfg, compute_dtype, cache, active, chunk):
    """Prefill (``cache`` None) or one decode step.  On a mesh, prefill
    takes u (b, s, E) batch-sharded, a sequence-sharded stream gathered
    first (:func:`.layers.whole_seq`), and returns u's placements; decode
    takes u (b, 1, E), every row, embed over ``data`` or whole, and the
    cache as laid out: each rank steps its cache rows and gathers the rows'
    gated outputs over the batch shards before ``w_out``."""
    Di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    decode = cache is not None
    u_pl = L.placements_of(u)
    if not decode:
        u = L.whole_seq(u)
    loc = Local.of(u)
    e_axes = L.sharded_axes(u, 2)
    w_in, w_out = L.mesh_weights(u, [p["w_in"], p["w_out"]], compute_dtype)
    small = [L.gather_all(p[n]) for n in ("conv_w", "conv_b", "dt_bias",
                                          "A_log", "D", "norm")]
    z_axes = L.sharded_axes(w_in, 1)       # w_in's output blocks
    h_axes = L.sharded_axes(p["A_log"], 0)  # the local heads
    di_axes = L.sharded_axes(w_out, 0)     # w_out's rows
    ins = [u, w_in, w_out] + small
    if decode:
        ins += [cache["state"], cache["conv"]]
        b_axes = L.sharded_axes(cache["state"], 0)
        c_axes = L.sharded_axes(cache["conv"], 2)
        act = None if active is None else active.to(L.local_device(u))

    def body(ul, wi, wo, conv_w, conv_b, dt_bias, A_log, D, norm, *cl):
        zx = loc.all_reduce(ul @ wi, e_axes)
        zx = loc.all_gather(zx, z_axes, dim=-1)
        z, xbc, dt = zx[..., :Di], zx[..., Di:2 * Di + 2 * N], \
            zx[..., 2 * Di + 2 * N:]
        nh = H // loc.size(h_axes)
        h0 = loc.rank(h_axes) * nh
        A = -torch.exp(A_log.to(f32))[h0:h0 + nh]
        Dh = D.to(f32)[h0:h0 + nh]
        cp = {"conv_w": conv_w, "conv_b": conv_b}
        if not decode:
            b, s = ul.shape[:2]
            xbc = _causal_conv(cp, xbc, compute_dtype)
            x = xbc[..., :Di].reshape(b, s, H, P)[:, :, h0:h0 + nh]
            B, C = xbc[..., Di:Di + N], xbc[..., Di + N:]
            dts = F.softplus(dt.to(f32) + dt_bias.to(f32))[..., h0:h0 + nh]
            y, _ = ssd_chunked(x, dts, A, B, C, chunk=min(chunk, s))
            y = y + Dh[None, None, :, None] * x.to(f32)
            y = y.reshape(b, s, nh * P)
            new = ()
        else:
            state, conv = cl
            bc = state.shape[0]
            rows = slice(loc.rank(b_axes) * bc, (loc.rank(b_axes) + 1) * bc)
            z, xbc, dt = z[rows], xbc[rows], dt[rows]
            nc = conv.shape[2]
            c0 = loc.rank(c_axes) * nc
            hist = torch.cat([conv, xbc[..., c0:c0 + nc]], dim=1)
            conv_out = torch.einsum("bkc,ck->bc", hist,
                                    conv_w[c0:c0 + nc].to(compute_dtype))
            conv_out = F.silu((conv_out + conv_b[c0:c0 + nc].to(
                compute_dtype)).to(f32))
            conv_out = loc.all_gather(conv_out, c_axes, dim=-1)
            x = conv_out[:, :Di].reshape(bc, H, P)[:, h0:h0 + nh]
            B, C = conv_out[:, Di:Di + N], conv_out[:, Di + N:]
            dts = F.softplus(dt[:, 0].to(f32) + dt_bias.to(f32))[:, h0:
                                                                  h0 + nh]
            S_new = state * torch.exp(dts * A[None])[..., None, None] \
                + torch.einsum("bn,bhp,bh->bhnp", B, x, dts)
            y = torch.einsum("bn,bhnp->bhp", C, S_new) + Dh[None, :, None] * x
            y = y.reshape(bc, 1, nh * P)
            new_conv = hist[:, 1:]
            if act is not None:
                ar = act[rows]
                S_new = torch.where(ar[:, None, None, None], S_new, state)
                new_conv = torch.where(ar[:, None, None], new_conv, conv)
            new = (S_new, new_conv)
        # gate and norm on the local heads' channels [h0 P, (h0 + nh) P)
        lo, hi = h0 * P, (h0 + nh) * P
        y = y.to(compute_dtype) * F.silu(z[..., lo:hi].to(f32)).to(
            compute_dtype)
        y = L.rms_local(y, norm[lo:hi], cfg.norm_eps, loc, h_axes)
        if decode:
            y = loc.all_gather(y, b_axes, dim=0)
        # w_out's local rows: the local heads' channels, or a slice of
        # all of them when the heads are whole but the rows split
        nr = wo.shape[0]
        if not h_axes:
            r0 = loc.rank(di_axes) * nr
            y = y[..., r0:r0 + nr]
        return (loc.all_reduce(y @ wo, di_axes),) + new

    outs = (L.placements_of(u),)
    if decode:
        outs += (L.placements_of(cache["state"]),
                 L.placements_of(cache["conv"]))
    res = L.on_shards(body, outs, *ins)
    if not decode:
        return L.with_placements(res[0], u_pl)
    return res[0], {"state": res[1], "conv": res[2]}
