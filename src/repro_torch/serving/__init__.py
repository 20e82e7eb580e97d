"""repro_torch.serving — the batched LM serving engine with request
clustering (mirror of ``repro.serving``)."""

from .engine import Request, ServingEngine  # noqa: F401
