"""Layers, the paged KV pool, the prefix cache and the CUDA attention
kernels (wrappers in ``attention_cuda``, sources in ``csrc/``)."""
