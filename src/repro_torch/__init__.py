"""PyTorch / CUDA port of the over-the-air FL system for an NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or JAX.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
