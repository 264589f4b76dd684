"""Pencil-decomposed distributed 3-D FFT over a 2-D device mesh.

PyTorch counterpart of :mod:`vpower_tpu.fft.distributed`.  The grid is
sharded (X/px, Y/py, Z full) over the entries of a
:class:`~vpower_tpu_torch.parallel.mesh.Mesh` and transformed with local
FFTs (``torch.fft``) along the unsharded axis plus two pencil transposes
(:func:`~vpower_tpu_torch.parallel.mesh._all_to_all`).

Layout walk (global array F[N, N, N], mesh axes ('x', 'y') of sizes
(px, py); local blocks in brackets):

    start      [N/px, N/py, N   ]   FFT along z
    a2a('y')   [N/px, N,    N/py]   FFT along y
    a2a('x')   [N,    N/px, N/py]   FFT along x

The final layout (X full, Y sharded by x-rank, Z sharded by y-rank) is
what spectrum binning wants: each entry bins its block with global k
offsets (:func:`vpower_tpu_torch.spectrum.power.shell_bin_local`) and
one sum over the mesh gives the full spectrum.

Where the JAX package's functions are local functions called inside
``jax.shard_map`` on one device's block, these take the mesh and a list
of blocks, one a local entry of the mesh in entry order, each on its
entry's device, and return such a list.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..parallel.mesh import _all_to_all, _local_entries
from ..spectrum.power import _power, power_norm

__all__ = [
    "pencil_fftn",
    "pencil_output_starts",
    "pencil_power_vector",
    "pencil_power_scalar",
]


def pencil_fftn(local: List[torch.Tensor], mesh,
                axis_names: Tuple[str, str] = ("x", "y")) -> List[torch.Tensor]:
    """3-D FFT of a globally (X/px, Y/py, Z) sharded array given as its
    local blocks.  Returns the local blocks in (X full, Y/x, Z/y)
    layout."""
    ax, ay = axis_names
    # FFT along the locally-full z axis.
    local = [torch.fft.fft(b, dim=2) for b in local]
    # Transpose pencils: unshard Y, shard Z over the y axis.
    local = _all_to_all(mesh, local, ay, split_axis=2, concat_axis=1)
    local = [torch.fft.fft(b, dim=1) for b in local]
    # Unshard X, shard Y over the x axis.
    local = _all_to_all(mesh, local, ax, split_axis=1, concat_axis=0)
    return [torch.fft.fft(b, dim=0) for b in local]


def pencil_output_starts(n_full: int, mesh,
                         axis_names: Tuple[str, str] = ("x", "y")
                         ) -> List[Tuple[int, int, int]]:
    """The (3,) global index offsets of each local entry's block in the
    pencil-FFT OUTPUT layout (X full, Y sharded by x-rank, Z sharded by
    y-rank)."""
    ax, ay = (mesh.axis_names.index(a) for a in axis_names)
    px, py = mesh.devices.shape[ax], mesh.devices.shape[ay]
    out = []
    for g, _ in _local_entries(mesh):
        r = np.unravel_index(g, mesh.devices.shape)
        out.append((0, int(r[ax]) * (n_full // px),
                    int(r[ay]) * (n_full // py)))
    return out


def pencil_power_vector(local_v: List[torch.Tensor], box_size: float,
                        n_full: int, mesh,
                        axis_names: Tuple[str, str] = ("x", "y")
                        ) -> List[torch.Tensor]:
    """Power grid of a sharded CHANNELS-FIRST (C, .., .., ..) real or
    complex vector field: sequential per-component pencil FFTs, ``P =
    0.5 sum |a F|^2`` (the normalization of
    :func:`~vpower_tpu_torch.spectrum.power.vector_power`)."""
    a = power_norm(box_size, n_full)
    acc = None
    for c in range(local_v[0].shape[0]):
        fk = pencil_fftn([v[c] for v in local_v], mesh, axis_names)
        p = [_power(f) for f in fk]
        acc = p if acc is None else [s + q for s, q in zip(acc, p)]
    return [s * (a * a) for s in acc]


def pencil_power_scalar(local_f: List[torch.Tensor], box_size: float,
                        n_full: int, mesh,
                        axis_names: Tuple[str, str] = ("x", "y")
                        ) -> List[torch.Tensor]:
    """Power grid of a sharded scalar field, normalized as
    :func:`pencil_power_vector`."""
    a = power_norm(box_size, n_full)
    fk = pencil_fftn(local_f, mesh, axis_names)
    return [_power(f) * (a * a) for f in fk]
