"""Device-mesh helpers: the replacement for ``MPI.COMM_WORLD``.

PyTorch counterpart of :mod:`vpower_tpu.parallel.mesh`.  The JAX package
lays a ``jax.sharding.Mesh`` over the devices one controller sees; the
port's :class:`Mesh` is its counterpart: a grid of ``torch.device``
entries with axis names, and for a mesh that spans processes the
``torch.distributed`` group that joins them
(:func:`vpower_tpu_torch.parallel.multihost.global_mesh`).  An entry may
repeat a device: several entries on one card, or CPU entries in tests.

Work placed on a mesh runs entry by entry from one Python loop; what
stands for ``psum`` sums the entries' partial results onto the first
entry's device in entry order, then ``all_reduce``s the process-local
sums over the group (:func:`vpower_tpu_torch.parallel.streamed`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["make_mesh", "mesh_shape_for"]


def _multi_gpu_not_ported(what: str):
    """The error every mesh scatter pipeline raises until ROADMAP item
    14b lands: a run never quietly falls back to one card."""
    return NotImplementedError(
        f"{what} runs the mesh scatter pipelines (pencil FFT, sharded "
        f"deposit), which belong to the port's slice 10b (ROADMAP item "
        f"14b) and are not ported yet; run on one card (--single-chip on "
        f"the command line)"
    )


def _device_array(devices: Sequence, shape) -> np.ndarray:
    """An object array of ``torch.device`` of ``shape`` (``np.asarray``
    would not keep the devices as scalars)."""
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


class Mesh:
    """A grid of devices with named axes, the counterpart of
    ``jax.sharding.Mesh``: ``devices`` (an object array of
    ``torch.device``), ``axis_names``, ``shape`` (axis name -> size) and
    ``size`` read as they do there.

    ``group`` is the ``torch.distributed`` process group of a mesh that
    spans processes (None in one process); ``process_ids`` (the shape of
    ``devices``) names the rank that holds each entry.  Only the entries
    of this process (``process_ids == process_index``) are addressable
    here; an entry's device is named as its own process names it."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 group=None, process_ids: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-d device array with axis names "
                f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        if process_ids is None:
            process_ids = np.zeros(devices.shape, np.int64)
        self.process_ids = np.asarray(process_ids, np.int64).reshape(
            devices.shape)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_index(self) -> int:
        """This process's rank in ``group`` (0 without one)."""
        if self.group is None:
            return 0
        return torch.distributed.get_rank(self.group)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Most-square (px, py) factorization with px >= py — balanced
    pencil dimensions minimize the larger all-to-all."""
    py = int(np.floor(np.sqrt(n_devices)))
    while n_devices % py != 0:
        py -= 1
    return n_devices // py, py


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    devices=None,
) -> Mesh:
    """2-D ('x', 'y') mesh over the visible cards, or over ``devices``
    (a list of devices; an entry may repeat one).  With no card in sight
    and no ``devices`` it raises: it never lays a mesh over the CPU on
    its own."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError(
                "make_mesh: no CUDA card is visible; pass devices= to lay "
                "a mesh over other devices (e.g. [torch.device('cpu')] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    if n_devices is None:
        n_devices = len(devices)
    if shape is None:
        shape = mesh_shape_for(n_devices)
    px, py = shape
    if px * py != n_devices or n_devices > len(devices):
        raise ValueError(
            f"mesh shape must cover n_devices exactly: {px} x {py} over "
            f"{n_devices} of {len(devices)} devices")
    return Mesh(_device_array(list(devices)[: px * py], (px, py)),
                ("x", "y"))
