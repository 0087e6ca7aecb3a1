"""Hand-written CUDA kernels, their build step and their plain PyTorch versions."""
