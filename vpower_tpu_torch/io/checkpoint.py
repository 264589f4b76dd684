"""Checkpoints of fields and folded fields (``.npz``).

PyTorch counterpart of :mod:`vpower_tpu.io.checkpoint`, with the same
keys and paths, so a checkpoint written by either package loads in the
other (the reference pickled them, ``interp.py:794-810``).  Loads go to
the card unless the caller names another device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.field import BoxField, FoldedField

__all__ = ["save_field", "load_field", "save_folded", "load_folded"]


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_field(path: str, field: BoxField) -> str:
    np.savez(_npz(path), velocity=field.velocity.cpu().numpy(),
             mass=field.mass.cpu().numpy(), cell_size=field.cell_size)
    return path


def load_field(path: str, device="cuda") -> BoxField:
    with np.load(_npz(path)) as z:
        return BoxField.from_numpy(z["velocity"], z["mass"],
                                   float(z["cell_size"]), device=device)


def _folded_path(out_dir: str, beta) -> str:
    # delimited, multi-digit-safe form of the reference scheme
    # folded_field_b{x}{y}{z}.pkl (interp.py:798)
    return os.path.join(out_dir, "folded_field_b{}_{}_{}.npz".format(*beta))


def save_folded(out_dir: str, folded: FoldedField) -> str:
    path = _folded_path(out_dir, folded.beta)
    np.savez(path, field=folded.field.cpu().numpy(),
             fold_factor=folded.fold_factor, beta=np.asarray(folded.beta),
             box_size=folded.box_size, total_box_size=folded.total_box_size)
    return path


def load_folded(out_dir: str, beta, device="cuda") -> FoldedField:
    path = _folded_path(out_dir, beta)
    if not os.path.isfile(path):  # legacy single-digit scheme
        legacy = os.path.join(out_dir,
                              "folded_field_b{}{}{}.npz".format(*beta))
        if os.path.isfile(legacy):
            path = legacy
    with np.load(path) as z:
        return FoldedField(
            field=torch.from_numpy(z["field"]).to(device),
            fold_factor=int(z["fold_factor"]),
            beta=tuple(int(b) for b in z["beta"]),
            box_size=float(z["box_size"]),
            total_box_size=float(z["total_box_size"]),
        )
