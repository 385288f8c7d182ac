"""Optimizers of the training path: AdamW (``optim.adamw``), the port of
``repro/optim/adamw.py``."""
