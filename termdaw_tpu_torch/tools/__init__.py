"""Measurement scripts of the port that need a CUDA card."""
