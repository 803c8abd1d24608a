"""cmdlmc_tpu_torch — the cMD/LMC kinetic Monte Carlo engine in PyTorch and CUDA.

A port of ``cmdlmc_tpu`` (the JAX/Pallas package, kept beside it as the
reference) to PyTorch with hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``). Module paths mirror the JAX package's, so
``cmdlmc_tpu/engine/fused.py`` corresponds to ``cmdlmc_tpu_torch/engine/fused.py``.

The package imports ``torch`` and never ``jax``. Every CUDA kernel has a plain
PyTorch version beside it in the same module; a wrapper runs the plain version
only for tensors on the CPU and launches its kernel for tensors on the card.
Configurations no kernel runs take the scan engine (``engine/lattice.py``,
``models/water.py``), whose random numbers are JAX's own threefry draws
(``ops/threefry.py``).
"""

__version__ = "0.1.0"
