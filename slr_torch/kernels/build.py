"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` at first use, where
``<hash>`` is the SHA-256 prefix of the source and of the headers it may
include (``csrc/*.cuh``), so an edited source or header rebuilds and an
unchanged one loads at once. A failed build raises with nvcc's stderr:
there is no fall-back. ``build_host_library`` does the same for a C++
source of the host tier (``slr_torch/native/plyio.cpp``) with ``g++``.

It also holds the launch contract that every kernel wrapper goes through:

- ``bind``: a library's entry points typed from one signature table;
- ``expect``: the inputs a kernel reads through raw pointers: each
  contiguous, of their shapes and dtypes, on one CUDA device;
- ``launch``: a call on PyTorch's current stream of the tensors' device, a
  non-zero status raised as ``RuntimeError`` with CUDA's error string, and
  the launch counted in ``slr_torch.observability``; ``check_status`` for
  the entry points that return a status but take no stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from slr_torch import observability as obs

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _compile(src: Path, name: str, command, headers=()) -> tuple[Path, str]:
    """Compile ``src`` with ``command`` (the compiler and its flags) into
    ``_build/lib<name>_<hash>.so`` unless that build exists; the hash
    covers ``src`` and ``headers``. Returns (path of the shared library,
    the compiler's log; empty when the library was already built)."""
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in (src, *headers))).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*command, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{command[0]} failed to build {src}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: no concurrent process loads half a file
    return lib, proc.stderr


def build_library(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` with nvcc unless its build is current.

    Returns (path of the shared library, nvcc's log; empty when the
    library was already built)."""
    return _compile(CSRC / f"{name}.cu", name, (_nvcc(), *NVCC_FLAGS),
                    sorted(CSRC.glob("*.cuh")))


def build_host_library(src: Path) -> tuple[Path, str]:
    """Compile the host C++ source ``src`` with ``g++ -O3 -shared -fPIC``
    unless its build is current; the library is named after the source's
    stem. Returns as ``build_library``."""
    src = Path(src)
    return _compile(src, src.stem, ("g++", *HOST_FLAGS))


def bind(name: str, signatures: dict):
    """A function returning the library of ``csrc/<name>.cu``, built,
    loaded and typed on its first call. ``signatures`` maps each entry
    point to its (restype, argtypes); ``slr_cuda_error_string``, which every
    source defines, is typed here."""
    signatures = {**signatures, "slr_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int])}

    @functools.cache
    def library() -> ctypes.CDLL:
        lib = ctypes.CDLL(str(build_library(name)[0]))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return lib

    return library


def expect(what: str, *want) -> None:
    """Raise ``ValueError`` unless every (tensor, shape, dtype) of ``want``
    is contiguous, of that shape and dtype, on the first tensor's CUDA
    device."""
    device = want[0][0].device
    if device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {device}")
    for x, shape, dtype in want:
        if x.shape != shape or x.dtype != dtype or x.device != device or not x.is_contiguous():
            raise ValueError(
                f"{what}: the inputs do not match: each must be contiguous, of its shape and "
                f"dtype, on one device ({device}); expected {dtype} {tuple(shape)}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device} (contiguous: {x.is_contiguous()})")


def check_status(lib: ctypes.CDLL, what: str, status: int) -> None:
    """Raise ``RuntimeError`` with CUDA's error string for a non-zero
    ``status`` of an entry point of ``lib``."""
    if status != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.slr_cuda_error_string(status).decode())


def launch(lib: ctypes.CDLL, fn: str, what: str, device: torch.device, *args,
           counter: str | None = None) -> None:
    """Call ``lib.<fn>(*args, device index, current stream)`` on PyTorch's
    current stream of ``device``; raise on a non-zero status (``what``
    names the kernel), else add 1 to the recorder's ``counter``, if any."""
    stream = torch.cuda.current_stream(device).cuda_stream
    check_status(lib, what, getattr(lib, fn)(*args, device.index, stream))
    if counter is not None:
        obs.count(counter)
