"""Plain PyTorch references: no kernel, no cache, no batching, and
nothing of ``repro_torch`` or of the JAX package."""
