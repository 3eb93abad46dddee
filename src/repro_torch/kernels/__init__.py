"""Hand-written CUDA kernels (csrc/) behind PyTorch wrappers, their plain
versions, and the execution-plan dispatch."""
