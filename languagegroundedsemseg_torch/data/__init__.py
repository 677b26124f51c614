"""Data layer: synthetic scenes, transforms, voxelizer, datasets, batch
assembly and the threaded loader."""
