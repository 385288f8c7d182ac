"""Model configurations: copies of the reference's ``repro/configs``
(the ``ModelConfig`` schema, the ten assigned architectures, the
registry and the shape cells), kept here so the port imports nothing of
``repro``.  They are data; which layer kinds the port can build is
decided in :mod:`repro_torch.models.model`."""
