"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Same module layout as ``repro`` (``kernels``, ``core``, ``api``, ``obs``,
``data``), so every ported module has one reference module to be held
against.  It imports torch and numpy, never JAX or ``repro``.
"""
