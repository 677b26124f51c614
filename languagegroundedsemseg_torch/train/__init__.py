"""Eval step (the serving entry point)."""
