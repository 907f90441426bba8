"""Solvers: sparse MMW, rounding and verification, binary search over Z."""
