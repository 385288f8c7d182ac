"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain
C interface, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, under ``build/repro_torch_kernels/`` at
the repository root, and loaded with ``ctypes``.  A library that
already exists under its hash is loaded as it is.  Nothing here runs at
import time: the CPU-only tests import every module, and only a launch
on a CUDA tensor asks for a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3]
             / "build" / "repro_torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double

#: C signature of every launcher and geometry export: (argtypes, source
#: file).
LAUNCHERS = {
    "chain_step_launch": (
        [_I, _I, _P, _P, _I, _I, _I, _I, _I, _P], "morph_chain.cu"),
    "geodesic_chain_step_launch": (
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "morph_chain.cu"),
    "geodesic_tile_step_launch": (
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "morph_chain.cu"),
    "geodesic_compact_step_launch": (
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "morph_chain.cu"),
    "qdt_chain_step_launch": (
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "qdt_chain.cu"),
    "qdt_tile_step_launch": (
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _P],
        "qdt_chain.cu"),
    "qdt_compact_step_launch": (
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "qdt_chain.cu"),
    "gdt_chain_step_launch": (
        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _P],
        "gdt_chain.cu"),
    "gdt_tile_step_launch": (
        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _P],
        "gdt_chain.cu"),
    "gdt_compact_step_launch": (
        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _P],
        "gdt_chain.cu"),
    # the launchers' geometry without a launch (repro_torch.analysis.
    # indexmaps holds its model against these): the shape of one call,
    # then every window of it
    "morph_geometry": ([_I] * 9 + [_P], "morph_chain.cu"),
    "morph_windows": ([_I] * 9 + [_P], "morph_chain.cu"),
    "qdt_geometry": ([_I] * 8 + [_P], "qdt_chain.cu"),
    "qdt_windows": ([_I] * 8 + [_P], "qdt_chain.cu"),
    "gdt_geometry": ([_I] * 8 + [_D, _P], "gdt_chain.cu"),
    "gdt_windows": ([_I] * 8 + [_D, _P], "gdt_chain.cu"),
}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def library_path(source: str) -> pathlib.Path:
    """Where ``source``'s library lives: named by a hash of the source
    text, the shared headers (``csrc/*.cuh``) and the compiler flags."""
    text = b"".join([(CSRC / source).read_bytes(),
                     *(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))])
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{pathlib.Path(source).stem}_{digest[:16]}.so"


def build(source: str) -> pathlib.Path:
    """Compile ``source`` unless its library exists; return its path.
    Raises with nvcc's output when the build fails."""
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for name, (argtypes, src) in LAUNCHERS.items():
                if src == source:
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def launcher(name: str):
    """The ctypes function of launcher ``name``."""
    return getattr(load(LAUNCHERS[name][1]), name)


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code:
        msg = load(LAUNCHERS[name][1]).repro_cuda_error_string(code)
        raise RuntimeError(f"{name}: CUDA error {code}: {msg.decode()}")


def build_all() -> list:
    """Build every source (one nvcc each, run together); returns the
    library paths.  ``chip_smoke.py`` calls this to time the build."""
    sources = sorted({src for _, src in LAUNCHERS.values()})
    threads, errors = [], []

    def run(src):
        try:
            build(src)
        except RuntimeError as e:  # re-raised below, with every failure
            errors.append(e)

    for src in sources:
        t = threading.Thread(target=run, args=(src,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(str(e) for e in errors))
    return [library_path(src) for src in sources]


#: The launchers' dtype codes.
DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2,
               torch.float32: 3, torch.float64: 4}


def dtype_code(dtype: torch.dtype) -> int:
    """The launchers' code for ``dtype`` (raises for one they do not
    take)."""
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take {sorted(map(str, DTYPE_CODES))}, "
            f"got {dtype}") from None


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device "
                             f"(or a CPU tensor for the plain version), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def launch(name: str, device: torch.device, *args) -> None:
    """Call launcher ``name`` on the current stream of ``device`` and
    raise on a CUDA error.  Tensors in ``args`` pass as pointers."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = launcher(name)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(name, code)
