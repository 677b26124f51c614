"""Res16UNet family over sparse voxel grids."""
