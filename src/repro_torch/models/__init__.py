"""repro_torch.models — the dense decoder-only LM of ``repro.models``
(configs in :mod:`repro_torch.configs`), its prefill through the
flash-attention kernel and its decode in plain torch; ``convert`` carries
the JAX package's parameters over for the tests."""
