"""Common layers: norms, RoPE, MLPs, embeddings, param declaration.

Mirrors of ``repro.models.layers``.  Parameters are plain nested dicts
of tensors; the reference's logical sharding axes have
no meaning on one card and are not kept.  A model's stacked layers are a
list of per-layer dicts (:mod:`.transformer`), not a leading axis.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------- #
# param declaration
# --------------------------------------------------------------------- #
def declare(gen: torch.Generator, decls: Dict[str, Tuple[Tuple[int, ...],
                                                         float]],
            dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """decls: name -> (shape, init_std), drawn on ``gen``'s device.  std
    0 => zeros, std < 0 => constant |std|, else normal * std (the
    reference's shapes and stds; torch's normal draws, not JAX's)."""
    dev = gen.device
    params = {}
    for name, (shape, std) in decls.items():
        if std == 0.0:
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif std < 0.0:
            params[name] = torch.full(shape, -std, dtype=dtype, device=dev)
        else:
            params[name] = torch.randn(shape, generator=gen, dtype=dtype,
                                       device=dev).mul_(std)
    return params


def fan_in_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


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
        "w_gate": ((d_model, d_ff), fan_in_std(d_model)),
        "w_up": ((d_model, d_ff), fan_in_std(d_model)),
        "w_down": ((d_ff, d_model), fan_in_std(d_ff)),
    }, dtype)


def swiglu(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(compute_dtype) * u
    return h @ p["w_down"].to(compute_dtype)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32):
    return declare(gen, {
        "w_in": ((d_model, d_ff), fan_in_std(d_model)),
        "b_in": ((d_ff,), 0.0),
        "w_out": ((d_ff, d_model), fan_in_std(d_ff)),
        "b_out": ((d_model,), 0.0),
    }, dtype)


def gelu_mlp(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Whisper's MLP.  ``jax.nn.gelu`` defaults to the tanh
    approximation, hence ``approximate="tanh"`` (not torch's exact
    default)."""
    h = x @ p["w_in"].to(compute_dtype)
    h = torch.nn.functional.gelu(
        (h + p["b_in"].to(compute_dtype)).to(torch.float32),
        approximate="tanh")
    out = h.to(compute_dtype) @ p["w_out"].to(compute_dtype)
    return out + p["b_out"].to(compute_dtype)


# --------------------------------------------------------------------- #
# embeddings / heads
# --------------------------------------------------------------------- #
def init_embedding(gen: torch.Generator, vocab_padded: int, d_model: int,
                   dtype=torch.float32):
    return declare(gen, {"table": ((vocab_padded, d_model), 1.0)}, dtype)


def embed(p, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # gather, then cast: bit-identical to the reference's cast-then-take,
    # without casting the whole table on every call
    return p["table"][tokens].to(compute_dtype)


def init_lm_head(gen: torch.Generator, d_model: int, vocab_padded: int,
                 dtype=torch.float32):
    return declare(gen, {"w": ((d_model, vocab_padded),
                               fan_in_std(d_model))}, dtype)


def lm_head(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x @ p["w"].to(compute_dtype)
