"""Hand-written CUDA kernels for the fused morphology chains, the
quasi-distance transform and the grey-weighted geodesic distance, their
plain PyTorch versions, and the drivers built on them.

Layer contract (mirrors ``repro.kernels``): every kernel wrapper takes
its code path from the tensor it is given — a CPU tensor runs the
plain PyTorch version in the same module, a CUDA tensor launches the
kernel or raises.  ``ops`` owns the padding/stacking layout, the
fixed-chain drivers and the active-cell requeue scheduler; ``ref``
re-exports the oracles under kernel-aligned names.  Everything here is
bit-exact against ``repro_torch.core.morphology``.
"""
