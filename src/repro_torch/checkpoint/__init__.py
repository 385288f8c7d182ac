"""Fault-tolerant checkpointing (``checkpoint.manager``), the port of
``repro/checkpoint``."""
