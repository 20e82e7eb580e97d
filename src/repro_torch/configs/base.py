"""Architecture configuration dataclass + reduced smoke variants.

The port's own copy of ``repro.configs.base`` (which imports no JAX): the
same fields, defaults and ``smoke()`` reduction, so a config built here
describes the same model as the reference's of the same name.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None   # gemma3 global layers
    window: Optional[int] = None                # sliding-window size
    local_global_pattern: Optional[Tuple[int, int]] = None  # e.g. (5, 1)
    attn_chunk: int = 512                       # q-chunk for flash-style jnp path
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # VLM (llava)
    n_patches: int = 0
    d_vision: int = 0
    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # memory knobs (per-shape overrides happen in launch/dryrun.py)
    seq_shard_activations: bool = False  # Megatron-SP residual stream
    remat: bool = True
    grad_accum: int = 1
    # metadata
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP sharding always divides."""
        return -(-self.vocab_size // 256) * 256

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6·N·D."""
        E, F, V = self.d_model, self.d_ff, self.vocab_size
        Hq, Hkv, Dh = self.n_heads, self.n_kv_heads, self.resolved_head_dim
        emb = V * E * (1 if self.tie_embeddings else 2)
        attn = E * (Hq + 2 * Hkv) * Dh + Hq * Dh * E
        mlp = 3 * E * F
        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn + mlp
        elif self.family == "moe":
            per_layer = attn + self.n_experts * 3 * E * F + E * self.n_experts
        elif self.family == "ssm":
            Di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = (
                E * (2 * Di + 2 * N + H) + (Di + 2 * N) * self.ssm_conv
                + Di * E + 2 * H + Di
            )
        elif self.family == "hybrid":
            Di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = (
                E * (2 * Di + 2 * N + H) + (Di + 2 * N) * self.ssm_conv
                + Di * E + 2 * H + Di
            )
            per_layer = attn + ssm + mlp
        elif self.family == "audio":
            # decoder layers have self+cross attention
            enc = self.n_encoder_layers * (attn + 2 * E * F + E * F)
            dec = self.n_layers * (2 * attn + 3 * E * F)
            return emb + enc + dec
        return emb + per_layer * self.n_layers

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        E, F = self.d_model, self.d_ff
        dense_like = self.n_params() - self.n_layers * (
            self.n_experts - self.top_k
        ) * 3 * E * F
        return dense_like

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            n_patches=min(self.n_patches, 4) if self.n_patches else 0,
            d_vision=32 if self.d_vision else 0,
            window=min(self.window, 32) if self.window else None,
            attn_chunk=32,
            grad_accum=1,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
