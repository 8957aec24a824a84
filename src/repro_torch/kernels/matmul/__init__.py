"""Tiled GEMM, the paper's benchmark app 1."""
