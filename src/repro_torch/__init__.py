"""PyTorch/CUDA port of the `repro` streaming ASR system.

Mirrors the module layout of `src/repro/` (the JAX package, which stays
the reference): `repro_torch/models/tds.py` ports `repro/models/tds.py`,
and so on.  The port imports torch and numpy, never jax and nothing of
`repro`.  Its kernels are hand-written CUDA for Hopper (`sm_90a`) in
`kernels/csrc/`, built with nvcc at first use.
"""
