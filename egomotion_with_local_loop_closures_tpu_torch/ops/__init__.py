"""Hand-written CUDA kernels and their PyTorch bindings."""
