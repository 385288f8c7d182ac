"""The one place engine names, devices and dtypes are defined,
validated and defaulted.

Two engines mirror the reference's two backends:

``"cuda"`` (the default)
    the padded, planned, scheduled engine — counterpart of ``"pallas"``.
    Its kernel wrappers launch the hand-written CUDA kernels on CUDA
    tensors and run their plain PyTorch versions on CPU tensors.
``"torch"``
    the unpadded oracle engine (``core.morphology`` bodies) —
    counterpart of ``"xla"``.

The *device* is separate from the engine.  ``device=None`` means
``"cuda"``: on a machine without a GPU that raises, it never quietly
runs on the CPU.  Callers that want the CPU ask for it
(``device="cpu"``), as the tests do.  Both engines are bit-exact
against the oracles on either device, so the choice may only change
*how* the result is computed, never the result.
"""
from __future__ import annotations

import warnings
from typing import Literal

import numpy as np
import torch

Backend = Literal["cuda", "torch"]

#: Every engine name a public entry point accepts.
BACKENDS: tuple[str, ...] = ("cuda", "torch")

#: The engine ``None`` resolves to.
DEFAULT_BACKEND = "cuda"


def default_backend() -> str:
    """The policy default: the ``"cuda"`` engine on every platform (the
    device, not the engine, says where it runs)."""
    return DEFAULT_BACKEND


def canonicalize_backend(backend: str | None) -> str:
    """Validate ``backend``, resolving ``None`` to the policy default."""
    if backend is None:
        return default_backend()
    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS} (or None for "
            f"{DEFAULT_BACKEND!r}), got {backend!r}"
        )
    return backend


def warn_legacy_kwargs(entry: str, *names: str) -> None:
    """Deprecation shim for the pre-expression call surfaces (the
    reference's, message and ``stacklevel`` alike).

    The legacy operator kwargs (``backend=``, ``max_iters=``,
    ``max_chunks=``) keep working, but new code should build an
    expression and bind the engine at ``repro_torch.api.compile`` time.
    """
    warnings.warn(
        f"{entry}: the {'/'.join(names)} argument(s) are deprecated; "
        "build an expression and pass them to repro_torch.api.compile("
        "expr, shape, dtype, backend, ...) instead",
        DeprecationWarning,
        stacklevel=3,
    )


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default, but no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return device


_NUMPY_TO_TORCH = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a NumPy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NUMPY_TO_TORCH[np.dtype(dtype)]


def dtype_name(dtype: torch.dtype) -> str:
    """NumPy-style name (``"uint8"``) for keys and messages."""
    return str(dtype).removeprefix("torch.")


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of a torch dtype."""
    for np_dtype, t in _NUMPY_TO_TORCH.items():
        if t == dtype:
            return np_dtype
    raise TypeError(f"no NumPy counterpart for {dtype}")
