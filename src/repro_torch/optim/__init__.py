"""Optimizers of the training path — ports of ``repro/optim``: AdamW
(``optim.adamw``) and the int8 gradient compression with error feedback
(``optim.compression``: ``init_error``, ``quantize``,
``psum_compressed``)."""
