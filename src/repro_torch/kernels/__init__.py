"""Hand-written CUDA kernels (the fabric hot path's three, flash
attention) and their plain PyTorch versions."""
