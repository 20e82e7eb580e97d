"""whisper-small: encoder-decoder 12L(+12L enc), d_model 768, 12H,
d_ff 3072, vocab 51865 — conv audio frontend is a STUB (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    source="arXiv:2212.04356",
)
