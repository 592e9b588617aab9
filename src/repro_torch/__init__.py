"""repro_torch — the PyTorch / CUDA port of ``repro`` (unwrapped ADMM with
transpose reduction) for an NVIDIA H100.

Same module paths as the JAX package (``repro_torch/engine/engine.py`` ports
``repro/engine/engine.py``). The package imports ``torch`` and never
``jax`` or ``repro``. Hand-written CUDA kernels live in ``kernels/csrc``
and are built at first use (``kernels/build.py``).
"""
