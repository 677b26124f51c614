"""Sparse voxel grids: offsets, containers, host graph build."""
