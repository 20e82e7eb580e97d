"""Common layers: norms, RoPE, MLPs, embeddings, param declaration.

Mirrors of ``repro.models.layers``.  Parameters are plain nested dicts
of tensors.  Every declared parameter carries the reference's logical
axes: an init called with ``gen=None`` returns the tree of them (the
reference's second return value) instead of drawing, and under
:func:`placing` each drawn leaf is placed at once (on a mesh: whole from
the generator, then this rank's block, so a sharded model starts from the
unsharded one's weights).  A model's stacked layers are a list of
per-layer dicts (:mod:`.transformer`), not a leading axis, so the
reference's ``layers`` axis is dropped.

Under a ``DeviceMesh`` the activations are DTensors, and the embedding,
the head, the MLPs and the norm run their bodies on local shards through
``local_map`` (:mod:`repro_torch.sharding.collectives`); each block has
one body, which :func:`on_shards` runs under ``local_map`` on a mesh and
directly on plain tensors, where its collectives are the identity.  The
embedding table is sharded over ``model`` on its embed dim
(``act_mlp``), the head over ``model`` on the vocabulary; a
sequence-sharded stream (``act_seq``) is gathered before attention, the
Mamba-2 mixer and the MLPs (:func:`whole_seq`); an MLP's weights are
gathered over
``data`` (ZeRO-3) for a full-sequence input, and consumed shard-local
against an embed-sharded decode input (``act_decode_embed``), whose
partial sums are reduced once per product.  For a gradient,
:func:`on_shards` gives each body input that is whole over an axis the
body's work is split over a partial-sum gradient there
(:func:`grad_placements`), and each collective its backward
(:mod:`repro_torch.sharding.collectives`).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Tuple

import torch

from ..sharding import shard_activation
from ..sharding.axes import mesh_axis_names
from ..sharding.collectives import Local

#: the mesh axes the data-parallel shards of a parameter lie on
DATA_AXES = ("pod", "data")


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------- #
# param declaration
# --------------------------------------------------------------------- #
_PLACE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_place",
                                                        default=None)


@contextlib.contextmanager
def placing(place):
    """Within the block, :func:`declare` hands each drawn parameter and
    its logical axes to ``place(tensor, axes)`` and keeps what it
    returns (a DTensor on a mesh)."""
    token = _PLACE.set(place)
    try:
        yield
    finally:
        _PLACE.reset(token)


def declare(gen, decls: Dict[str, Tuple[Tuple[int, ...], Tuple, float]],
            dtype=torch.float32):
    """decls: name -> (shape, logical_axes, init_std), drawn on ``gen``'s
    device.  std 0 => zeros, std < 0 => constant |std|, else normal * std
    (the reference's shapes and stds; torch's normal draws, not JAX's).
    ``gen=None``: the logical axes instead, drawing nothing."""
    if gen is None:
        return {name: ax for name, (_, ax, _) in decls.items()}
    dev = gen.device
    place = _PLACE.get()
    params = {}
    for name, (shape, ax, std) in decls.items():
        if std == 0.0:
            t = torch.zeros(shape, dtype=dtype, device=dev)
        elif std < 0.0:
            t = torch.full(shape, -std, dtype=dtype, device=dev)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype,
                            device=dev).mul_(std)
        params[name] = t if place is None else place(t, ax)
    return params


def fan_in_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


# --------------------------------------------------------------------- #
# the mesh path's helpers
# --------------------------------------------------------------------- #
def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def placements_of(t):
    """A DTensor's placements; None for a plain tensor."""
    return t.placements if is_dtensor(t) else None


def local_device(t) -> torch.device:
    """The device of ``t``'s local shard (of ``t`` for a plain tensor)."""
    return t.to_local().device if is_dtensor(t) else t.device


def lmap(body, out_placements, in_placements, mesh, in_grad=None):
    """``local_map`` with explicit placements in and out (the
    reference's ``shard_map`` in_specs / out_specs) and, for a gradient,
    the placements of each input's gradient (``in_grad``; default its
    own)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    def one(pl):
        return None if pl is None else list(pl)

    # one output: a placement list; several: a tuple of lists
    single = all(isinstance(p, Placement) for p in out_placements)
    out = one(out_placements) if single else \
        tuple(one(p) for p in out_placements)
    return local_map(body, out_placements=out,
                     in_placements=tuple(one(p) for p in in_placements),
                     in_grad_placements=None if in_grad is None else
                     tuple(one(p) for p in in_grad),
                     device_mesh=mesh)


def grad_placements(args, whole=None):
    """The placements of the gradients of a body's inputs ``args``: an
    input whole (``Replicate``) over a mesh axis that some input is
    split over (an axis of extent > 1 the body's work is divided by)
    takes its gradient as a partial sum there (``Partial``), except on
    the axes ``whole[i]`` names for input ``i`` (read only after the
    body's reduction over them, so every rank holds the whole
    gradient).  None for a plain tensor."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return None
    mesh = dts[0].device_mesh
    names = mesh_axis_names(mesh)
    split = {d for a in dts for d, p in enumerate(a.placements)
             if isinstance(p, Shard) and mesh.size(d) > 1}
    whole = whole or {}
    return tuple(
        None if not is_dtensor(a) else
        tuple(Partial() if isinstance(p, Replicate) and d in split
              and names[d] not in whole.get(i, ()) else p
              for d, p in enumerate(a.placements))
        for i, a in enumerate(args))


def on_shards(body, out_placements, *args, whole=None):
    """``body(*args)`` on local shards: under :func:`lmap` with the
    arguments' placements in, ``out_placements`` out and the gradients'
    placements of :func:`grad_placements` when ``args[0]`` is a DTensor;
    directly on plain tensors, where the body's :class:`Local`
    collectives are the identity."""
    if not is_dtensor(args[0]):
        return body(*args)
    return lmap(body, out_placements,
                tuple(placements_of(a) for a in args),
                args[0].device_mesh,
                in_grad=grad_placements(args, whole))(*args)


def sharded_axes(t, dim: int) -> Tuple[str, ...]:
    """The mesh axes (of extent > 1) that split dimension ``dim`` of the
    DTensor ``t``, in mesh order; none for a plain tensor."""
    if not is_dtensor(t):
        return ()
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    dim %= t.ndim
    return tuple(n for i, (n, p) in enumerate(zip(mesh_axis_names(mesh),
                                                  t.placements))
                 if isinstance(p, Shard) and p.dim == dim
                 and mesh.size(i) > 1)


def with_placements(t, placements):
    """A DTensor ``t`` redistributed to ``placements``; a plain tensor
    as it is."""
    if not is_dtensor(t) or tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def whole_seq(x):
    """``x`` with its sequence (every dimension but the batch, dim 0, and
    the embed dim, the last) whole: what a block reads whose positions
    mix (attention, the Mamba-2 conv and scan) or whose ``model`` shards
    are not positions (the MLP's ``mlp`` dim).  A sequence-sharded
    residual stream (``act_seq``) is gathered here, where the
    reference's compiler inserts the gather."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    last = x.ndim - 1
    return with_placements(x, [
        Replicate() if isinstance(p, Shard) and 0 < p.dim < last else p
        for p in x.placements])


def gather_data(w, compute_dtype):
    """``w`` cast to the compute dtype, then gathered over the data axes
    (ZeRO-3: a full-sequence block contracts whole weights); its
    ``model`` shard stays."""
    if not is_dtensor(w):
        return w.to(compute_dtype)
    from torch.distributed.tensor import Replicate

    names = mesh_axis_names(w.device_mesh)
    want = [Replicate() if n in DATA_AXES else p
            for n, p in zip(names, w.placements)]
    return with_placements(w.to(compute_dtype), want)


def gather_all(w):
    """``w`` whole on every rank (the small parameters a body reads in
    full: norm scales, conv taps, per-head constants)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    return with_placements(w, [Replicate()] * w.device_mesh.ndim)


def mesh_weights(x, ws, compute_dtype):
    """The weights ``ws`` as a body over ``x`` consumes them, in the
    compute dtype: whole over ``data`` for a full-sequence ``x``
    (:func:`gather_data`); shard-local for an embed-sharded (decode)
    ``x``, whose products the body reduces over ``data``."""
    if not is_dtensor(x) or sharded_axes(x, x.ndim - 1):
        return [w.to(compute_dtype) for w in ws]
    return [gather_data(w, compute_dtype) for w in ws]


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def rms_local(x, scale, eps: float, loc: Local, axes) -> torch.Tensor:
    """RMS norm of ``x``'s last dim, split over ``axes`` (whole when
    empty): the sum of squares reduced over them; ``scale`` is this
    shard's slice."""
    xf = x.to(torch.float32)
    if axes:
        # every rank normalises its slice by the shared variance: the
        # backward sums the slices' shares of its cotangent
        var = loc.all_reduce((xf * xf).sum(-1, keepdim=True), axes,
                             grad="sum") / (x.shape[-1] * loc.size(axes))
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """On a mesh ``x``'s last dim may be sharded (a decode input over
    ``data``); ``scale`` (replicated) is read at each rank's slice."""
    loc = Local.of(x)
    axes = sharded_axes(x, x.ndim - 1)

    def body(xl, sl):
        n = xl.shape[-1]
        r = loc.rank(axes)
        return rms_local(xl, sl[r * n:(r + 1) * n], eps, loc, axes)

    return on_shards(body, placements_of(x), x, scale)


# --------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: (..., seq) int; theta a scalar
    (per layer).  Angles in f32, in the reference's order."""
    dh = x.shape[-1]
    half = dh // 2
    f32 = torch.float32
    freq = torch.exp(
        -torch.log(torch.full((), theta, dtype=f32, device=x.device))
        * (torch.arange(half, dtype=f32, device=x.device) / half))
    ang = positions[..., None].to(f32) * freq  # (..., seq, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #
def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    return declare(gen, {
        "w_gate": ((d_model, d_ff), ("embed", "mlp"), fan_in_std(d_model)),
        "w_up": ((d_model, d_ff), ("embed", "mlp"), fan_in_std(d_model)),
        "w_down": ((d_ff, d_model), ("mlp", "embed"), fan_in_std(d_ff)),
    }, dtype)


def _mlp(p, x, compute_dtype, names, act):
    """``act(x @ w_in...) @ w_out``.  On a mesh a sequence-sharded ``x``
    is gathered first (:func:`whole_seq`) and the output takes its
    placements; the down projection's partial sums over ``model`` (a
    sharded ``mlp`` dim) are reduced once, and an embed-sharded ``x``'s
    first products over ``data`` once each."""
    xin = whole_seq(x)
    loc = Local.of(xin)
    ws = mesh_weights(xin, [p[n] for n in names], compute_dtype)
    e_axes = sharded_axes(xin, xin.ndim - 1)
    f_axes = sharded_axes(ws[-1], 0)

    def body(xl, *wl):
        *w_in, w_out = wl
        hs = [loc.all_reduce(xl @ w, e_axes) for w in w_in]
        return loc.all_reduce(act(*hs) @ w_out, f_axes)

    y = on_shards(body, placements_of(xin), xin, *ws)
    return with_placements(y, placements_of(x))


def swiglu(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return _mlp(p, x, compute_dtype, ("w_gate", "w_up", "w_down"),
                lambda g, u: torch.nn.functional.silu(g.to(torch.float32))
                .to(compute_dtype) * u)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32):
    return declare(gen, {
        "w_in": ((d_model, d_ff), ("embed", "mlp"), fan_in_std(d_model)),
        "b_in": ((d_ff,), ("mlp",), 0.0),
        "w_out": ((d_ff, d_model), ("mlp", "embed"), fan_in_std(d_ff)),
        "b_out": ((d_model,), ("embed_r",), 0.0),
    }, dtype)


def gelu_mlp(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Whisper's MLP.  ``jax.nn.gelu`` defaults to the tanh
    approximation, hence ``approximate="tanh"`` (not torch's exact
    default).  ``b_in`` lies as ``w_in``'s ``mlp`` shard; ``b_out`` is
    read at an embed-sharded ``x``'s slice."""
    loc = Local.of(x)
    e_axes = sharded_axes(x, x.ndim - 1)
    w_in, w_out = mesh_weights(x, [p["w_in"], p["w_out"]], compute_dtype)
    b_in = p["b_in"].to(compute_dtype)
    b_out = gather_all(p["b_out"].to(compute_dtype))
    f_axes = sharded_axes(w_out, 0)

    def body(xl, wl_in, wl_out, bl_in, bl_out):
        h = torch.nn.functional.gelu(
            (loc.all_reduce(xl @ wl_in, e_axes) + bl_in).to(torch.float32),
            approximate="tanh")
        out = loc.all_reduce(h.to(compute_dtype) @ wl_out, f_axes)
        n = out.shape[-1]
        r = loc.rank(e_axes)
        return out + bl_out[r * n:(r + 1) * n]

    # b_out is added after the reduction over f_axes: its gradient is
    # whole there
    return on_shards(body, placements_of(x), x, w_in, w_out, b_in, b_out,
                     whole={4: f_axes})


# --------------------------------------------------------------------- #
# embeddings / heads
# --------------------------------------------------------------------- #
def init_embedding(gen: torch.Generator, vocab_padded: int, d_model: int,
                   dtype=torch.float32):
    # table replicated over data, sharded over model on the embed dim so
    # the token gather stays local
    return declare(gen, {"table": ((vocab_padded, d_model),
                                   (None, "act_mlp"), 1.0)}, dtype)


def embed(p, tokens: torch.Tensor, compute_dtype, mesh=None) -> torch.Tensor:
    """Gather, then cast: bit-identical to the reference's
    cast-then-take, without casting the whole table on every call.  On a
    mesh the tokens are sharded over the batch and the table over
    ``model`` on its embed dim: the gather is local, its output sharded
    on the embed dim."""
    from torch.distributed.tensor import Replicate, Shard

    tokens = shard_activation(tokens, ("batch", None), mesh)
    table = p["table"]
    out = None if mesh is None else [
        Shard(0) if isinstance(tp, Shard) else
        Shard(2) if isinstance(wp, Shard) else Replicate()
        for tp, wp in zip(tokens.placements, table.placements)]
    y = on_shards(lambda t, tok: t[tok].to(compute_dtype), out, table,
                  tokens)
    return shard_activation(y, ("batch", None, "act_mlp"), mesh)


def init_lm_head(gen: torch.Generator, d_model: int, vocab_padded: int,
                 dtype=torch.float32):
    return declare(gen, {"w": ((d_model, vocab_padded), ("embed_r", "vocab"),
                               fan_in_std(d_model))}, dtype)


def lm_head(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return head(p["w"], x, compute_dtype, tied=False)


def head(w, x, compute_dtype, tied: bool):
    """``x @ w`` (``w`` (E, V)); tied, ``x @ table.T`` (the embedding
    table (V, E)).  On a mesh the logits are sharded over ``model`` on
    the vocabulary (``act_vocab``): ``w`` is vocab-sharded; the tied
    table is sharded on E, whose partial logits are reduced over
    ``model`` once."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = getattr(x, "device_mesh", None)
    loc = Local(mesh)
    x = shard_activation(x, ("batch",) + (None,) * (x.ndim - 2)
                         + ("act_embed",), mesh)
    w = w.to(compute_dtype)
    e_axes = sharded_axes(w, 1) if tied else ()
    v_axes = () if tied else sharded_axes(w, 1)
    out = None if mesh is None else [
        p if isinstance(p, Shard) and p.dim == 0 else
        Shard(x.ndim - 1) if n in v_axes else Replicate()
        for n, p in zip(mesh_axis_names(mesh), x.placements)]

    def body(xl, wl):
        if not tied:
            return xl @ wl
        n = wl.shape[1]
        r = loc.rank(e_axes)
        return loc.all_reduce(xl[..., r * n:(r + 1) * n] @ wl.T, e_axes)

    y = on_shards(body, out, x, w)
    return shard_activation(y, ("batch",) + (None,) * (x.ndim - 2)
                            + ("act_vocab",), mesh)
