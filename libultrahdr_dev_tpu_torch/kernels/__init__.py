"""Hand-written CUDA kernels of the port (csrc/) and their build."""
