"""hymba-1.5b: hybrid 32L, d_model 1600, 25H GQA(kv=5), d_ff 5504,
ssm_state 16 — parallel attention+mamba heads.  [arXiv:2411.13676; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    source="arXiv:2411.13676",
)
