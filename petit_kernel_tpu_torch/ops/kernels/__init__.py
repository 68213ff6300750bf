"""Hand-written CUDA kernels' wrappers with their plain PyTorch twins."""
