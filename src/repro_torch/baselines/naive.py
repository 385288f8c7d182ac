"""Naive chain execution: one whole-image pass per elementary filter,
each its own dispatch with a device sync in between (port of
``repro.baselines.naive``).

This reproduces how iterative libraries (SMIL/OpenCV, paper §1) compute
geodesic operators: every filter of the chain re-streams the full image
through main memory.  It is the *unfused* baseline against which the
paper's (and our) locality win is measured.  Both functions run on
``device`` (``None`` is the GPU, which raises without one; the CPU must
be asked for) and move their inputs there.
"""
from __future__ import annotations

import torch

from repro_torch.core import morphology as M
from repro_torch.core.backend import resolve_device


def _sync(x: torch.Tensor) -> None:
    """Wait for the step that made ``x`` (a no-op on the CPU, where
    PyTorch runs synchronously)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def chain(f, n: int, op: str = "erode", device=None) -> torch.Tensor:
    """n elementary filters, one dispatch + device sync each."""
    f = torch.as_tensor(f, device=resolve_device(device))
    step = M.erode3 if op == "erode" else M.dilate3
    for _ in range(n):
        f = step(f)
        _sync(f)
    return f


def reconstruct(f, m, op: str = "erode", device=None) -> torch.Tensor:
    """Reconstruction with a host-side convergence check per iteration
    (the ``bool`` reads the device's answer back)."""
    device = resolve_device(device)
    f, m = torch.as_tensor(f, device=device), torch.as_tensor(m,
                                                               device=device)
    step = M.geodesic_erode1 if op == "erode" else M.geodesic_dilate1
    while True:
        nxt = step(f, m)
        if not bool(M.not_equal(nxt, f).any()):
            return nxt
        f = nxt
