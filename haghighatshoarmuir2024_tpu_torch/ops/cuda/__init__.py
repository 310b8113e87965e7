"""CUDA kernels for Hopper (csrc/) and their PyTorch wrappers."""
