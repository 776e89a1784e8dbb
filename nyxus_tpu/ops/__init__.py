"""Batched feature kernels (JAX/XLA)."""
