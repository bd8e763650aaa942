"""PyTorch/CUDA port of the multi-precision floating-point system (see
``repro`` for the JAX reference).  Imports torch and numpy, never jax."""
