"""Hand-written CUDA kernels of the port, their build and wrappers."""
