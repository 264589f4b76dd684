"""Multi-host initialization.

PyTorch counterpart of :mod:`vpower_tpu.parallel.multihost`, with its
signatures.  The reference scaled past one node with MPI (``mpiexec -n
N``, SURVEY.md §2.3 MPICH row); here every process joins one
``torch.distributed`` group and lays out :func:`global_mesh` over the
entries of all processes.  Block-parallel work then runs each process's
own entries and combines with one ``all_reduce``
(:func:`vpower_tpu_torch.parallel.distributed_streamed_sweep`).

The backend follows ``device`` as the port's other entry points do:
``nccl`` on the card (the default), ``gloo`` only for ``device="cpu"``.
Single-process environments (tests, one-card hosts) skip initialization
and behave identically.

Usage on each host (e.g. under ``torchrun``, which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``)::

    from vpower_tpu_torch.parallel import multihost
    multihost.initialize()                    # from torchrun's environment
    # or explicitly:
    multihost.initialize("10.0.0.1:9999", num_processes=4, process_id=i)
    mesh = multihost.global_mesh(inner=4)     # 4 cards per inner axis
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh, _device_array

__all__ = ["initialize", "global_mesh", "is_multiprocess"]

# how long a collective (the rendezvous included) may wait for the other
# processes before it raises instead of hanging the run
_TIMEOUT = datetime.timedelta(seconds=120)


def _backend(device) -> str:
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Join the processes of a run into one ``torch.distributed`` group
    (idempotent: a no-op while a group is up).

    With no coordinator and ``num_processes`` in ``(None, 1)`` it does
    nothing, unless ``torchrun`` set ``WORLD_SIZE`` above 1: then the
    group starts from that environment.  Otherwise the group meets at
    ``tcp://<coordinator_address>`` with the given size and rank.  The
    backend is ``nccl`` for ``device="cuda"`` and ``gloo`` for
    ``device="cpu"``; it is never chosen from what the host has."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = _backend(device)
    if coordinator_address is None and num_processes in (None, 1):
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=_TIMEOUT)
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "multihost.initialize: a multi-process run needs "
            "coordinator_address, num_processes and process_id (or the "
            "environment torchrun sets)")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_TIMEOUT)


def is_multiprocess() -> bool:
    """Whether a process group with more than one process is up."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def _local_devices(device):
    """This process's entries: the CPU, or its share of the visible cards
    (all of them, unless ``torchrun`` started several processes on this
    host: then the ``LOCAL_RANK``-th of ``LOCAL_WORLD_SIZE`` equal
    shares)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    n_cards = torch.cuda.device_count()
    n_here = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    share = n_cards // n_here
    if share == 0:
        raise RuntimeError(
            f"global_mesh: {n_cards} visible cards for {n_here} processes "
            f"on this host")
    return [torch.device("cuda", local_rank * share + j)
            for j in range(share)]


def global_mesh(inner: Optional[int] = None, axis_names=("x", "y"), *,
                device="cuda") -> Mesh:
    """2-D mesh over the entries of every process, the process group
    attached: process r holds entries ``r * n_local ... (r + 1) * n_local
    - 1`` in mesh order, so the 'y' (inner) axis stays within a process
    when ``inner`` divides its entry count.  Every process contributes
    the same number of entries, as hosts of one run do."""
    import torch.distributed as dist

    local = _local_devices(device)
    n_local = len(local)
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    n = world * n_local
    if inner is None:
        inner = n_local
        while n % inner != 0:
            inner -= 1
    if n % inner != 0:
        raise ValueError("inner axis must divide the device count")
    shape = (n // inner, inner)
    return Mesh(_device_array(local * world, shape), axis_names, group=group,
                process_ids=np.repeat(np.arange(world), n_local)
                .reshape(shape))
