"""GEMM API, solution space, repack layout and kernel build (torch)."""
