"""gemma3-27b: dense 62L, d_model 5376, 32H GQA(kv=16), d_ff 21504,
vocab 262144 — 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    window=1024,
    local_global_pattern=(5, 1),
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    grad_accum=4,
    source="hf:google/gemma-3-1b-pt",
)
