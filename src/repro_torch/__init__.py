"""repro_torch — the PyTorch/CUDA port of :mod:`repro`.

Module names mirror ``src/repro/``: each reference module has one
counterpart here, written in plain PyTorch over tensors with an
explicit ``device``.  The four fused Pallas kernels of the main path
(fixed chains and Alg. 4 reconstruction) are hand-written CUDA C++ for
Hopper (``kernels/csrc/morph_chain.cu``), built with ``nvcc`` at first
use.  This package never imports ``jax`` or anything of ``repro``; only
the tests hold the two against each other, bit for bit.
"""
