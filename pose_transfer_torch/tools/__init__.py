"""Measurement scripts of the port (need a CUDA device)."""
