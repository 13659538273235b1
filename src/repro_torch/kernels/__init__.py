"""The port's hand-written CUDA kernels, their plain PyTorch versions
(``ref``) and the dispatchers (``ops``)."""
