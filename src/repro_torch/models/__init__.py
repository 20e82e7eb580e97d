"""repro_torch.models — the LMs of ``repro.models`` (configs in
:mod:`repro_torch.configs`): the decoder-only dense, moe, ssm, hybrid
and vlm families and the audio encoder-decoder, their prefill attention
through the flash-attention kernel and their decode in plain torch;
``convert`` carries the JAX package's parameters over for the tests."""
