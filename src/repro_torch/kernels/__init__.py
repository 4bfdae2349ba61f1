"""Hand-written CUDA kernels (the fabric hot path's three, flash
attention, the Mamba2 SSD scan) and their plain PyTorch versions."""
