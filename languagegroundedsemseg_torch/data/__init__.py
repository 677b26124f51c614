"""Data layer: synthetic scenes and batch assembly."""
