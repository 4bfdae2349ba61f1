"""Hand-written CUDA kernels of the fabric hot path and their plain
PyTorch versions."""
