"""Benchmark timing on the CUDA card (torch)."""
