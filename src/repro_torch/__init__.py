"""PyTorch + CUDA port of the TurboTransformers reproduction.

The JAX package `repro` stays the reference; this package serves the same
dense and MoE decoders on one NVIDIA H100 through hand-written Hopper kernels
(see README.md in this directory).  It imports nothing of `repro` and
nothing of JAX.
"""
