"""llava-next-mistral-7b: VLM 32L, d_model 4096, 32H GQA(kv=8), d_ff 14336,
vocab 32000 — anyres patch tiling; vision frontend is a STUB (input_specs
provides precomputed patch embeddings).  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_patches=576,
    d_vision=1024,
    grad_accum=2,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
