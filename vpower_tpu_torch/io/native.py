"""ctypes bindings for the native host runtime (``native/vpower_host.cpp``).

PyTorch-side twin of :mod:`vpower_tpu.io.native`: the same library,
paths and staleness rule (``make`` rebuilds it when it is missing or
older than its source), no second build.  It gives the C++ host layer:
Gadget-2 legacy binary snapshots, OpenMP Morton pre-sorting, the exact
kd-tree NN oracle, threaded raw-brick I/O and the streamed pipeline's
candidate selection.  Every function takes and returns host numpy
arrays (torch tensors are copied to the host first); without a
toolchain they raise ``NativeUnavailable``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "NativeUnavailable",
    "native_available",
    "load_gadget_binary",
    "morton_argsort",
    "morton_sort_particles",
    "nn_exact_query",
    "nn_exact_host",
    "BrickPrefetcher",
    "brick_write_raw",
    "brick_read_raw",
    "block_candidates_host",
    "single_block_rows_host",
]


class NativeUnavailable(RuntimeError):
    pass


_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvpower_host.so")
_lib = None


def _stale() -> bool:
    """True when the .so is missing or older than its C++ source — the
    library is built on demand and never committed (it would be a
    host-CPU-specific binary blob that silently shadows source edits)."""
    if not os.path.isfile(_LIB_PATH):
        return True
    src = os.path.join(_NATIVE_DIR, "vpower_host.cpp")
    return os.path.isfile(src) and os.path.getmtime(src) > os.path.getmtime(
        _LIB_PATH
    )


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-B"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception as e:  # no toolchain / build failure
            if not os.path.isfile(_LIB_PATH):
                raise NativeUnavailable(
                    f"native library missing and build failed: {e}"
                ) from e
    lib = ctypes.CDLL(_LIB_PATH)

    c_ll = ctypes.c_longlong
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.read_gadget_binary.restype = c_ll
    lib.read_gadget_binary.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.morton_argsort.restype = None
    lib.morton_argsort.argtypes = [f32p, c_ll, ctypes.c_double, i64p]
    lib.permute_floats.restype = None
    lib.permute_floats.argtypes = [f32p, i64p, c_ll, ctypes.c_int, f32p]
    lib.brick_prefetcher_create.restype = ctypes.c_void_p
    lib.brick_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.brick_prefetch_start.restype = ctypes.c_int
    lib.brick_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p, c_ll]
    lib.brick_prefetch_finish.restype = ctypes.c_int
    lib.brick_prefetch_finish.argtypes = [ctypes.c_void_p, f32p, c_ll]
    lib.brick_write.restype = ctypes.c_int
    lib.brick_write.argtypes = [ctypes.c_char_p, f32p, c_ll]
    lib.brick_read.restype = ctypes.c_int
    lib.brick_read.argtypes = [ctypes.c_char_p, f32p, c_ll]
    lib.nn_exact.restype = ctypes.c_int
    lib.nn_exact.argtypes = [
        f32p, c_ll, f32p, c_ll, ctypes.c_double, ctypes.c_int, i64p,
    ]
    lib.block_candidates.restype = c_ll
    lib.block_candidates.argtypes = [
        f32p, f32p, f32p, c_ll, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.single_block_rows.restype = c_ll
    lib.single_block_rows.argtypes = [
        f32p, f32p, f32p, c_ll, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, c_ll,
    ]
    _lib = lib
    return lib


def _host(a, dtype=np.float32) -> np.ndarray:
    """C-contiguous host copy (or view) of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype)


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


# ---------------------------------------------------------------------- #
# Gadget-2 legacy binary snapshots                                       #
# ---------------------------------------------------------------------- #
def load_gadget_binary(
    path: str, snap_format: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Read gas particles from a Gadget-2 SnapFormat 1/2 binary snapshot.

    Returns ``(pos, vel, mass, rho, box_size)`` as host numpy arrays —
    the legacy-binary sibling of :func:`..snapshot.load_snapshot`
    (reference HDF5 path, ``interp.py:84-131``).
    """
    lib = _load()
    box = ctypes.c_double(0.0)
    n = lib.read_gadget_binary(
        path.encode(), snap_format, None, None, None, None, ctypes.byref(box)
    )
    if n < 0:
        raise IOError(f"failed to parse Gadget binary snapshot {path!r}")
    pos = np.empty((n, 3), np.float32)
    vel = np.empty((n, 3), np.float32)
    mass = np.empty((n,), np.float32)
    rho = np.empty((n,), np.float32)
    n2 = lib.read_gadget_binary(
        path.encode(), snap_format,
        pos.ctypes.data_as(ctypes.c_void_p),
        vel.ctypes.data_as(ctypes.c_void_p),
        mass.ctypes.data_as(ctypes.c_void_p),
        rho.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(box),
    )
    if n2 != n:
        raise IOError(f"short read from Gadget binary snapshot {path!r}")
    return pos, vel, mass, rho, float(box.value)


# ---------------------------------------------------------------------- #
# Morton pre-sort                                                        #
# ---------------------------------------------------------------------- #
def morton_argsort(pos: np.ndarray, box_size: float) -> np.ndarray:
    """(N,) int64 permutation sorting particles into Z-order — the host
    spatial index that plays the role of the reference's persisted Annoy
    index (``parallel_optimized.py:297-313``)."""
    lib = _load()
    pos = _host(pos)
    order = np.empty((pos.shape[0],), np.int64)
    lib.morton_argsort(pos, pos.shape[0], float(box_size), order)
    return order


def morton_sort_particles(particles):
    """A new Particles set in Morton order (permuted on the host), on the
    input's device."""
    from ..core.particles import Particles

    lib = _load()
    pos = _host(particles.pos)
    n = pos.shape[0]
    order = np.empty((n,), np.int64)
    lib.morton_argsort(pos, n, float(particles.box_size), order)
    dev = particles.pos.device

    def perm(arr, width):
        src = _host(arr).reshape(n, width)
        out = np.empty_like(src)
        lib.permute_floats(src, order, n, width, out)
        return torch.from_numpy(out.reshape(arr.shape)).to(dev)

    return Particles(pos=perm(particles.pos, 3),
                     mass=perm(particles.mass, 1),
                     density=perm(particles.density, 1),
                     vel=perm(particles.vel, 3),
                     box_size=particles.box_size)


# ---------------------------------------------------------------------- #
# raw brick I/O with background prefetch                                 #
# ---------------------------------------------------------------------- #
def nn_exact_query(
    pts: np.ndarray, queries: np.ndarray, box_size: float,
    periodic: bool = True,
) -> np.ndarray:
    """Exact nearest-neighbor indices of ``queries`` among ``pts`` via
    the native kd-tree — the genuinely exact path for pathologically
    clustered inputs where the device multigrid's residual is bounded
    by a cell diagonal (``deposit/nn.py`` docstring).  Reference
    parity: exact ANN with eps=0 (``interp.py:1027-1034``)."""
    lib = _load()
    pts = _host(pts)
    queries = _host(queries)
    out = np.empty((queries.shape[0],), np.int64)
    rc = lib.nn_exact(
        pts, pts.shape[0], queries, queries.shape[0],
        float(box_size), int(bool(periodic)), out,
    )
    if rc != 0:
        raise RuntimeError("nn_exact failed")
    return out


def nn_exact_host(
    pos, n_grid: int, box_size: float, periodic: bool = True
) -> np.ndarray:
    """(N, N, N) int64 exact NN assignment of the cell-center lattice —
    the host oracle with the same contract as
    :func:`..deposit.nn.nn_assign`."""
    axis = (np.arange(n_grid, dtype=np.float32) + 0.5) * (
        np.float32(box_size) / n_grid
    )
    cx, cy, cz = np.meshgrid(axis, axis, axis, indexing="ij")
    queries = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)
    idx = nn_exact_query(pos, queries, box_size, periodic)
    return idx.reshape((n_grid,) * 3)


class BrickPrefetcher:
    """Double-buffered raw-brick reader: while the device folds brick i,
    a worker thread reads brick i+1 from disk — overlapping the
    reference's sequential ``np.load`` streaming (``interp.py:867-879``).
    """

    def __init__(self):
        self._lib = _load()
        self._handle = self._lib.brick_prefetcher_create()

    def start(self, path: str, n_floats: int) -> None:
        rc = self._lib.brick_prefetch_start(self._handle, path.encode(),
                                            n_floats)
        if rc != 0:
            raise RuntimeError("prefetcher busy")

    def finish(self, n_floats: int) -> np.ndarray:
        out = np.empty((n_floats,), np.float32)
        rc = self._lib.brick_prefetch_finish(self._handle, out, n_floats)
        if rc != 0:
            raise IOError("brick prefetch failed")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.brick_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def brick_write_raw(path: str, data: np.ndarray) -> None:
    lib = _load()
    flat = _host(data).ravel()
    if lib.brick_write(path.encode(), flat, flat.size) != 0:
        raise IOError(f"failed to write brick {path!r}")


def brick_read_raw(path: str, n_floats: int) -> np.ndarray:
    lib = _load()
    out = np.empty((n_floats,), np.float32)
    if lib.brick_read(path.encode(), out, n_floats) != 0:
        raise IOError(f"failed to read brick {path!r}")
    return out


def block_candidates_host(
    pos: np.ndarray,
    vel: np.ndarray,
    rho: np.ndarray,
    m: int,
    box: float,
    margin_phys: float,
):
    """Threaded native build of the streamed pipeline's per-block
    candidate runs (the layout contract of the JAX package's
    ``run/streamed.py:_block_candidates``).  Returns ``(rows (R + pad, 7)
    f32, starts (m^3,),
    counts (m^3,), pad)``."""
    lib = _load()
    pos, vel, rho = _host(pos), _host(vel), _host(rho)
    n = pos.shape[0]
    n_t = m**3
    counts = np.zeros((n_t,), np.int64)
    total = lib.block_candidates(
        pos, vel, rho, n, m, float(box), float(margin_phys),
        None, None, counts.ctypes.data_as(ctypes.c_void_p),
    )
    if total < 0:
        raise ValueError("block_candidates: margin exceeds the box")
    pad = max(int(counts.max()), 1)
    rows = np.zeros((total + pad, 7), np.float32)
    starts = np.zeros((n_t,), np.int64)
    got = lib.block_candidates(
        pos, vel, rho, n, m, float(box), float(margin_phys),
        rows.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        None,
    )
    if got != total:
        raise RuntimeError("block_candidates: pass disagreement")
    return rows, starts, counts, pad


def single_block_rows_host(
    pos: np.ndarray,
    vel: np.ndarray,
    rho: np.ndarray,
    m: int,
    box: float,
    margin_phys: float,
    q3,
) -> Tuple[np.ndarray, int]:
    """Threaded native candidate selection for ONE block at an
    arbitrary margin — the certificate escalation path (the layout
    contract of the JAX package's ``run/streamed.py:_single_block_rows``).
    Returns ``(rows (k, 7) f32, k)`` in ascending particle order."""
    lib = _load()
    pos, vel, rho = _host(pos), _host(vel), _host(rho)
    n = pos.shape[0]
    qx, qy, qz = (int(x) for x in q3)
    # single pass with a capacity guess (expected occupancy x 3 + floor);
    # the true count comes back, so an undersized buffer just retries
    ext_frac = min((1.0 / m + 2.0 * margin_phys / box), 1.0) ** 3
    cap = int(max(4096, 3.0 * ext_frac * n + 1024))
    while True:
        rows = np.zeros((cap, 7), np.float32)
        k = int(lib.single_block_rows(
            pos, vel, rho, n, m, float(box), float(margin_phys),
            qx, qy, qz, rows.ctypes.data_as(ctypes.c_void_p), cap,
        ))
        if k <= cap:
            return rows, k
        cap = k
