"""Snapshot I/O: Gadget/AREPO-style HDF5 -> host numpy -> device tensors.

PyTorch counterpart of :mod:`vpower_tpu.io.snapshot` (reference
``load_snapshot``, ``vpower/interp.py:84-131``, and ``init_dir``,
``interp.py:56-79``).  ``h5py`` is imported inside the functions that
read or write HDF5, so importing the package does not need it.  Loads
go to the card unless the caller names another device.
"""
from __future__ import annotations

import glob
import os
import shutil

import numpy as np
import torch

from ..core.particles import Particles

__all__ = ["load_snapshot", "save_snapshot", "init_dir"]

_FIELDS = ("Coordinates", "Masses", "Density", "Velocities")


def _snapshot_files(path) -> list:
    """Expand a snapshot spec into the files it names: a single file, an
    explicit list, a glob pattern, or a directory of split snapshot
    parts (Gadget-4/Arepo ``snap_550.0.hdf5 .. .N.hdf5``).  An existing
    literal path wins even if it holds glob metacharacters (e.g.
    ``run[1]/snap.hdf5``)."""
    if isinstance(path, (list, tuple)):
        files = [str(p) for p in path]
    elif os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.hdf5"))
                       + glob.glob(os.path.join(path, "*.h5")))
    elif os.path.exists(path):
        files = [str(path)]
    elif any(c in str(path) for c in "*?["):
        files = sorted(glob.glob(str(path)))
    else:
        files = [str(path)]
    if not files:
        raise FileNotFoundError(f"no snapshot files match {path!r}")
    return files


def load_snapshot(
    path,
    box_size: float = 1.0,
    remove_bulk_velocity: bool = True,
    shift_to_origin: bool = True,
    dtype=torch.float32,
    device="cuda",
) -> Particles:
    """Read ``PartType0/{Coordinates,Masses,Density,Velocities}`` from an
    HDF5 snapshot, or from the parts a glob, a directory or a list names
    (concatenated in file order), onto ``device``; bulk-velocity removal
    and the shift to the origin run there."""
    import h5py

    parts = {key: [] for key in _FIELDS}
    for fname in _snapshot_files(path):
        with h5py.File(fname, "r") as f:
            g = f["PartType0"]
            for key, acc in parts.items():
                acc.append(np.asarray(g[key][:], dtype=np.float32))

    def put(key):
        xs = parts[key]
        arr = xs[0] if len(xs) == 1 else np.concatenate(xs)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    particles = Particles(pos=put("Coordinates"), mass=put("Masses"),
                          density=put("Density"), vel=put("Velocities"),
                          box_size=float(box_size))
    if remove_bulk_velocity:
        particles = particles.remove_bulk_velocity()
    if shift_to_origin:
        particles = particles.shift_to_origin()
    return particles


def save_snapshot(path: str, particles: Particles) -> None:
    """Write a Particles set in the same HDF5 layout (the reference never
    writes snapshots; this is for round trips)."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("PartType0")
        for key, t in zip(_FIELDS, (particles.pos, particles.mass,
                                    particles.density, particles.vel)):
            g.create_dataset(key, data=t.cpu().numpy())
        f.attrs["box_size"] = particles.box_size


def init_dir(run_output_dir: str, auto_overwrite: bool = False) -> str:
    """Create (or confirm-overwrite) a run output folder (reference
    ``init_dir``, ``interp.py:56-79``); ``auto_overwrite`` skips the
    prompt."""
    if not os.path.exists(run_output_dir):
        os.makedirs(run_output_dir)
        return run_output_dir
    if not auto_overwrite:
        print("Warning: output folder already exists. Overwrite? (y/n): ",
              end="")
        if input() != "y":
            raise SystemExit("Output folder exists and overwrite declined.")
    shutil.rmtree(run_output_dir)
    os.makedirs(run_output_dir)
    return run_output_dir
