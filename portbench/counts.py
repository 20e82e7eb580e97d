"""The benchmark's own count of a step's work and its table of peaks.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense (no sparsity):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Any, Dict

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def _heads(arch: Dict[str, Any]):
    E, Hq = arch["d_model"], arch["n_heads"]
    return Hq, arch["n_kv_heads"], arch.get("head_dim") or E // Hq


def matmul_params_per_token(arch: Dict[str, Any]) -> int:
    """Weights of the matrix products one token goes through: the
    attention projections, the MLP (moe: the router and its ``top_k``
    experts), the head over the vocabulary."""
    E, F, V = arch["d_model"], arch["d_ff"], arch["vocab_size"]
    Hq, Hkv, Dh = _heads(arch)
    attn = E * (Hq + 2 * Hkv) * Dh + Hq * Dh * E
    if arch["family"] == "moe":
        mlp = E * arch["n_experts"] + arch["top_k"] * 3 * E * F
    else:
        mlp = 3 * E * F
    return arch["n_layers"] * (attn + mlp) + E * V


def model_flops(arch: Dict[str, Any], batch: int, seq: int) -> float:
    """A training step's model FLOPs: 6 x matmul weights x tokens, plus
    causal attention's 6 s^2 d (d = heads x head size) a sequence and
    layer; the backward's recompute is not counted."""
    Hq, _, Dh = _heads(arch)
    dense = 6 * matmul_params_per_token(arch) * batch * seq
    attn = 6 * seq * seq * Hq * Dh * batch * arch["n_layers"]
    return float(dense + attn)


def flash_forward_work(arch: Dict[str, Any], batch: int, seq: int):
    """(operations, bytes) of one causal flash-attention forward of a
    layer: 4 dh per unmasked (query, key) pair and query head; q, k, v
    read once and the output written once, in bf16."""
    Hq, Hkv, Dh = _heads(arch)
    pairs = seq * (seq + 1) // 2
    ops = 4 * Dh * pairs * batch * Hq
    nbytes = (2 * batch * Hq * seq * Dh + 2 * batch * Hkv * seq * Dh) \
        * BF16_BYTES
    return ops, nbytes


def flash_bound_s(arch: Dict[str, Any], batch: int, seq: int) -> float:
    """The least time one such launch can take on the card."""
    ops, nbytes = flash_forward_work(arch, batch, seq)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
