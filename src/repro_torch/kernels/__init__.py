"""Hand-written CUDA kernels (csrc/) with their launch wrappers and plain
PyTorch versions; ``ops`` dispatches by tensor device."""
