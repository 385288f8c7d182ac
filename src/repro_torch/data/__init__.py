"""Synthetic images and token streams (copied from ``repro.data``; NumPy
only)."""
