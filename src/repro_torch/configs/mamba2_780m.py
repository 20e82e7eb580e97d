"""mamba2-780m: SSM (attention-free) 48L, d_model 1536, ssm_state 128 —
SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    source="arXiv:2405.21060",
)
