"""PyTorch/CUDA port of the AB-Sparse serving path.

A package beside the JAX reference (``repro``) that imports nothing of it.
Module names mirror ``repro`` so each counterpart is easy to find; the two
TPU kernels of the serving path (``fused_decode``, ``sparse_prefill``) are
hand-written CUDA for Hopper under ``csrc/``.
"""
