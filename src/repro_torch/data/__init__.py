"""Synthetic images (copied from ``repro.data``; NumPy only)."""
