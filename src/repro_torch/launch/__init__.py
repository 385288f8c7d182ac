"""Launchers of the language-model path (``python -m
repro_torch.launch.serve``)."""
