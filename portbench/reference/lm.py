"""Plain reference of the two configurations' training step: the
decoder-only LM of granite-20b (dense) and of granite-moe-1b-a400m
(routed experts), its loss and gradients by autograd, and AdamW.

It computes what the configuration states, in float32 with TF32 off
(:func:`precise`), with no kernel, cache or batching of the port's:

* the embedding's row of each token; per layer ``x += attn(rms(x))``
  then ``x += mlp(rms(x))``, where ``rms(x) = x / sqrt(mean(x^2) + eps)
  * (1 + w)``;
* attention: q, k, v projections, rotary embedding of each head's two
  halves (angles ``pos * theta^(-i / half)``), causal softmax of
  ``q.k / sqrt(dh)`` with query head ``h`` reading kv head ``h // (hq /
  hkv)``, the output projection;
* dense: SwiGLU ``(silu(x Wg) * x Wu) Wd``; moe: router softmax over the
  experts (f32), the top ``k`` of them with their probabilities
  renormalised (``/ (sum + 1e-9)``), each token through its ``k``
  experts' SwiGLU only, weighted; the load-balance loss ``X * sum_e f_e
  P_e`` (``f``: the share of routed slots, ``P``: the mean
  probability), summed over the layers, enters the loss times 0.01;
* the head over the vocabulary padded to a multiple of 256, logits past
  the vocabulary masked; the loss is the mean next-token cross entropy;
* AdamW as configured: the global gradient norm clipped to
  ``clip_norm``, moments ``b1`` / ``b2``, bias corrections, decoupled
  weight decay on the parameter, the learning rate warmed up linearly
  then cosine, computed in float32.

Each layer is recomputed in the backward (``torch.utils.checkpoint``) so
that the whole batch fits beside the state.

Departures from the published models, as the configurations note: a
llama-style block for granite-20b (the published one is GPTBigCode-style:
LayerNorm, learned positions, GELU); no muP multipliers and an untied
head for granite-moe-1b-a400m.

``numerics`` rounds every matrix product's operands: ``"f32"`` leaves
them, ``"fp8"`` (the control) rounds each to float8 e4m3 with a
per-tensor scale, the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0


def precise() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x):
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def rounded(x: torch.Tensor, numerics: str) -> torch.Tensor:
    if numerics == "f32":
        return x
    if numerics == "fp8":
        return _Fp8.apply(x)
    raise ValueError(numerics)


def mm(a, b, numerics):
    return rounded(a, numerics) @ rounded(b, numerics)


def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x, theta):
    s, dh = x.shape[-2], x.shape[-1]
    half = dh // 2
    freq = torch.exp(-math.log(theta) * (
        torch.arange(half, dtype=F32, device=x.device) / half))
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, arch, numerics):
    b, s, E = h.shape
    Hq, Hkv = arch["n_heads"], arch["n_kv_heads"]
    Dh = arch.get("head_dim") or E // Hq

    def proj(w, heads):
        return mm(h, w.reshape(E, heads * Dh), numerics).view(
            b, s, heads, Dh).transpose(1, 2)

    theta = arch.get("rope_theta", 10_000.0)
    q = rope(proj(p["wq"], Hq), theta)
    k = rope(proj(p["wk"], Hkv), theta)
    v = proj(p["wv"], Hkv)
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    masked = ~torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    rows = []
    for r in range(b):  # one sequence's scores at a time
        scores = mm(q[r], k[r].transpose(-1, -2), numerics) / math.sqrt(Dh)
        probs = torch.softmax(scores.masked_fill(masked, -1e30), dim=-1)
        rows.append(mm(probs, v[r], numerics))
    out = torch.stack(rows).transpose(1, 2).reshape(b, s, Hq * Dh)
    return mm(out, p["wo"].reshape(Hq * Dh, E), numerics)


def swiglu(h, wg, wu, wd, numerics):
    return mm(F.silu(mm(h, wg, numerics)) * mm(h, wu, numerics), wd,
              numerics)


def routed_experts(p, h, arch, numerics):
    """Each token through its top-k experts only -> (y, aux)."""
    b, s, E = h.shape
    X, k = arch["n_experts"], arch["top_k"]
    x = h.reshape(b * s, E)
    probs = torch.softmax(mm(x, p["router"], numerics), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    gates = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(x)
    for e in range(X):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                     numerics)
        y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    f = F.one_hot(idx, X).to(F32).sum(-2).mean(0)
    aux = X * torch.sum(f * probs.mean(0))
    return y.reshape(b, s, E), aux


def layer(x, p, arch, numerics):
    eps = arch.get("norm_eps", 1e-6)
    x = x + attention(p["attn"], rms(x, p["ln_attn"]["w"], eps), arch,
                      numerics)
    h = rms(x, p["ln_mlp"]["w"], eps)
    if arch["family"] == "moe":
        y, aux = routed_experts(p["moe"], h, arch, numerics)
        return x + y, aux
    m = p["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"], numerics), \
        torch.zeros((), dtype=F32, device=x.device)


def loss_fn(params, arch, tokens, labels, numerics="f32"):
    """Mean next-token CE (+ 0.01 * the summed load-balance loss)."""
    x = params["embed"]["table"][tokens]
    aux = torch.zeros((), dtype=F32, device=x.device)
    for lp in params["layers"]:
        x, a = checkpoint(layer, x, lp, arch, numerics, use_reentrant=False)
        aux = aux + a
    x = rms(x, params["ln_f"]["w"], arch.get("norm_eps", 1e-6))
    logits = mm(x, params["head"]["w"], numerics)
    vp = logits.shape[-1]
    iota = torch.arange(vp, device=logits.device)
    logits = logits.masked_fill(iota >= arch["vocab_size"], -1e30)
    ce = F.cross_entropy(logits.reshape(-1, vp), labels.reshape(-1))
    return ce + 0.01 * aux


def lr_at(step: int, opt: Dict[str, Any]) -> float:
    """Warmup then cosine to a tenth, in float32."""
    base, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    s = torch.tensor(float(step), dtype=F32)
    if s < warm:
        return float(base * s / max(warm, 1))
    t = torch.clamp((s - warm) / max(total - warm, 1), 0.0, 1.0)
    return float(base * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * t))))


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def train(params, arch, batches: List[Dict[str, torch.Tensor]],
          opt: Dict[str, Any], numerics: str = "f32") -> Dict[str, Any]:
    """AdamW steps on ``batches`` from ``params`` (updated in place):
    each step's loss and, per leaf (``a.b.0.c``), the norm of the first
    step's clipped gradient."""
    named = [(".".join(map(str, path)), t) for path, t in leaves(params)]
    for _, t in named:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    b1, b2 = opt["b1"], opt["b2"]
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, start=1):
        loss = loss_fn(params, arch, batch["tokens"], batch["labels"],
                       numerics)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [t.grad for _, t in named]
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
            lr = lr_at(step, opt)
            s32 = torch.tensor(float(step), dtype=F32)
            bc1 = float(1 - torch.tensor(b1, dtype=F32) ** s32)
            bc2 = float(1 - torch.tensor(b2, dtype=F32) ** s32)
            for (name, p), g, mi, vi in zip(named, grads, m, v):
                g = g * scale
                if step == 1:
                    first_grad[name] = float(torch.linalg.vector_norm(g))
                mi.mul_(b1).add_(g * (1 - b1))
                vi.mul_(b2).add_(g * g * (1 - b2))
                upd = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
                p.grad = None
    for _, t in named:
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first_grad}
