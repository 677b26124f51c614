"""The benchmark of languagegroundedsemseg_torch: its harness, its plain
reference and the arithmetic of its metrics. Nothing here imports JAX or
the JAX package; only ``program.py`` imports the port."""
