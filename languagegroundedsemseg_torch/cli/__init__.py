"""Command-line entry points: training (``main``) and the reference
checkpoint converter (``convert``)."""
