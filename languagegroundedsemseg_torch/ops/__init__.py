"""Sparse conv ops and the Hopper kernels they launch."""
