"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  At first use it
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` (listed in ``.gitignore``), keyed by a hash of the
source and the flags, and loaded with ``ctypes``.  Nothing but the
repository's sources goes in.  A failed build raises.

This module is imported only by the kernel wrappers, when a kernel is
about to be launched on a CUDA tensor: importing the package needs
neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

# -fmad=false: no FMA contraction, so every distance rounds exactly as
# the JAX package's separate multiply and add (a contracted d2 can flip
# a nearest-neighbour tie).  No --use_fast_math: IEEE division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict = {}
# per kernel: nvcc's output of the build this process ran (ptxas lists
# registers, shared memory and spills per kernel); empty when cached
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of vpower_tpu_torch cannot be built"
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = _SRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = _OUT / f"{name}-{digest}.so"
        if not out.exists():
            _OUT.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {res.returncode}):\n{res.stderr}{res.stdout}"
                )
            os.replace(tmp, out)
            BUILD_LOG[name] = res.stderr + res.stdout
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
