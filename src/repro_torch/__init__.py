"""repro_torch — the PyTorch/CUDA port of :mod:`repro`.

Module names mirror ``src/repro/``: each reference module has one
counterpart here, written in plain PyTorch over tensors with an
explicit ``device``.  The reference's ten fused Pallas kernels are
hand-written CUDA C++ for Hopper (``kernels/csrc``: ``morph_chain.cu``
for the fixed chains and the Alg. 4 reconstruction, ``qdt_chain.cu``
for the quasi-distance transform, ``gdt_chain.cu`` for the
grey-weighted geodesic distance), built with ``nvcc`` at first use.
This package never imports ``jax`` or anything of ``repro``; only the
tests hold the two against each other, bit for bit.
"""
