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
sums over the group (:func:`vpower_tpu_torch.parallel.streamed`).  The
mesh scatter pipelines add two exchanges along one mesh axis, the
counterparts of ``jax.lax.all_to_all(tiled=True)`` and of the cyclic
``jax.lax.ppermute``: :func:`_all_to_all` and :func:`_ppermute_next`.
Between two entries of one process an exchange copies into a buffer of
the receiver's own (``.to(device)`` alone would alias two entries on one
device); between processes it is one ``batch_isend_irecv`` over the
mesh's group.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["make_mesh", "mesh_shape_for"]


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


def _local_entries(mesh: Mesh):
    """``[(flat entry index, device)]`` of this process's entries, in
    entry (row-major) order: the entries a per-entry list holds."""
    procs = mesh.process_ids.reshape(-1)
    me = mesh.process_index
    devs = mesh.devices.reshape(-1)
    return [(g, torch.device(devs[g])) for g in range(mesh.size)
            if procs[g] == me]


def _axis_lines(mesh: Mesh, axis: str):
    """The entries of each line of the mesh along ``axis``: lists of flat
    entry indices in axis order, one list a line."""
    a = mesh.axis_names.index(axis)
    idx = np.moveaxis(np.arange(mesh.size).reshape(mesh.devices.shape),
                      a, -1)
    return [list(line) for line in idx.reshape(-1, idx.shape[-1])]


def _exchange(mesh: Mesh, moves, send, like: torch.Tensor):
    """Move tensors between entries.  ``moves`` lists ``(src, dst)`` flat
    entry pairs in one order that every process shares; ``send(src,
    dst)`` gives what a local ``src`` sends, each of the shape and dtype
    of ``like``.  Returns ``{(src, dst): tensor}`` for every local
    ``dst``: a buffer of its own on its device.  Pairs within this
    process copy; the others are posted in ``moves`` order as one
    ``batch_isend_irecv`` over the mesh's group, so the sends from one
    process to another meet the receives there in the same order."""
    procs = mesh.process_ids.reshape(-1)
    devs = mesh.devices.reshape(-1)
    me = mesh.process_index
    got, ops, keep = {}, [], []
    for src, dst in moves:
        src_here, dst_here = procs[src] == me, procs[dst] == me
        if dst_here:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device=torch.device(devs[dst]))
            got[(src, dst)] = buf
            if src_here:
                buf.copy_(send(src, dst))
            else:
                ops.append(torch.distributed.P2POp(
                    torch.distributed.irecv, buf, _peer(mesh, procs[src]),
                    mesh.group))
        elif src_here:
            t = send(src, dst).contiguous()
            keep.append(t)
            ops.append(torch.distributed.P2POp(
                torch.distributed.isend, t, _peer(mesh, procs[dst]),
                mesh.group))
    if ops:
        for work in torch.distributed.batch_isend_irecv(ops):
            work.wait()
    return got


def _peer(mesh: Mesh, rank) -> int:
    """The global rank of ``rank`` in the mesh's group."""
    return torch.distributed.get_global_rank(mesh.group, int(rank))


def _all_to_all(mesh: Mesh, parts, axis: str, split_axis: int,
                concat_axis: int):
    """The tiled ``jax.lax.all_to_all`` along the mesh axis ``axis``:
    each entry splits its block of ``parts`` (one tensor a local entry,
    in entry order, all of one shape) into ``n`` equal chunks along
    ``split_axis``; chunk ``j`` goes to the ``j``-th entry of its line
    along ``axis``, which concatenates what it receives along
    ``concat_axis`` in source order.  Returns the received blocks, one a
    local entry."""
    local = [g for g, _ in _local_entries(mesh)]
    part = dict(zip(local, parts))
    lines = _axis_lines(mesh, axis)
    n = len(lines[0])
    shape = list(parts[0].shape)
    if shape[split_axis] % n:
        raise ValueError(f"all_to_all over {n} entries: axis {split_axis} "
                         f"of {tuple(shape)} does not split evenly")
    c = shape[split_axis] // n
    pos_in_line = {g: (line, j) for line in lines for j, g in enumerate(line)}
    moves = [(src, dst) for line in lines for dst in line for src in line]

    def send(src, dst):
        j = pos_in_line[dst][1]
        return part[src].narrow(split_axis, j * c, c)

    got = _exchange(mesh, moves, send, parts[0].narrow(split_axis, 0, c))
    return [torch.cat([got[(src, g)] for src in pos_in_line[g][0]],
                      dim=concat_axis) for g in local]


def _ppermute_next(mesh: Mesh, parts, axis: str):
    """The cyclic ``+1`` shift along the mesh axis ``axis`` (the
    ``ppermute`` of ``halo_add``): entry ``i`` of each line sends its
    tensor of ``parts`` to entry ``(i + 1) % n``; an axis of size 1 sends
    to itself.  Returns what each local entry received."""
    local = [g for g, _ in _local_entries(mesh)]
    part = dict(zip(local, parts))
    prev = {}
    moves = []
    for line in _axis_lines(mesh, axis):
        for i, src in enumerate(line):
            dst = line[(i + 1) % len(line)]
            prev[dst] = src
            moves.append((src, dst))
    got = _exchange(mesh, moves, lambda src, dst: part[src], parts[0])
    return [got[(prev[g], g)] for g in local]
