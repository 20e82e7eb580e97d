from .adamw import AdamW, warmup_cosine  # noqa: F401
