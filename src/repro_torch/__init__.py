"""PyTorch / CUDA port of the JAX package ``repro``, slice by slice.

It imports torch and numpy and nothing of ``repro`` or JAX.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.
"""
