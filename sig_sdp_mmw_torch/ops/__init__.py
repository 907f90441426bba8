"""Sparse operators: block-sparse SpMM, ELL gathers, batched Lanczos."""
