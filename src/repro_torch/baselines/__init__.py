"""The paper's comparison methods (§4.3), ported from
``repro.baselines``: naive per-filter iteration (SMIL-like, one dispatch
and one device sync per elementary filter), van Herk/Gil-Werman, the
pixel-pump queue algorithm and a hierarchical-queue reconstruction
oracle (the last two NumPy-only copies of the reference's)."""
