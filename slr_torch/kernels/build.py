"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` at first use, where
``<hash>`` is the source's SHA-256 prefix, so an edited source rebuilds and
an unchanged one loads at once. A failed build raises with nvcc's stderr:
there is no fall-back. ``build_host_library`` does the same for a C++
source of the host tier (``slr_torch/native/plyio.cpp``) with ``g++``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def _compile(src: Path, name: str, command) -> tuple[Path, str]:
    """Compile ``src`` with ``command`` (the compiler and its flags) into
    ``_build/lib<name>_<hash>.so`` unless that build exists. Returns (path
    of the shared library, the compiler's log; empty when the library was
    already built)."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
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
    return _compile(CSRC / f"{name}.cu", name, (_nvcc(), *NVCC_FLAGS))


def build_host_library(src: Path) -> tuple[Path, str]:
    """Compile the host C++ source ``src`` with ``g++ -O3 -shared -fPIC``
    unless its build is current; the library is named after the source's
    stem. Returns as ``build_library``."""
    src = Path(src)
    return _compile(src, src.stem, ("g++", *HOST_FLAGS))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build_library(name)[0]))
