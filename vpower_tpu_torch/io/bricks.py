"""Out-of-core brick decomposition: fields too large for one device,
streamed from disk brick by brick.

PyTorch counterpart of :mod:`vpower_tpu.io.bricks` (reference
``BrickInventory``, ``vpower/interp.py:818-962``): an nbrick^3 array of
n_brick^3 sub-fields on disk with a JSON manifest, built from particles
by :meth:`BrickStore.from_particles` (the repaired ``interp_to_brick``)
and combined by the streaming fold.  The files are those of the JAX
package (same names, ``.npz`` keys and raw layout), so a store written
by either package loads in the other.  Bricks load onto
``BrickStore.device``, the card unless the caller names another.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.field import BoxField, FoldedField
from ..core.particles import Particles
from ..spectrum.fold import apply_phase, fold_field, get_phase

__all__ = ["BrickStore"]


def _brick_path(d: str, r: int, s: int, t: int) -> str:
    # the reference's brick_field_loc{r}{s}{t}.npy (interp.py:858-864)
    # with multi-digit-safe separators
    return os.path.join(d, f"brick_field_loc{r}_{s}_{t}.npz")


@dataclasses.dataclass
class BrickStore:
    """nbrick^3 bricks of n_brick^3 cells each on disk.

    ``fmt='npz'`` stores ``.npz`` files; ``fmt='raw'`` stores flat
    float32 ``[v, mass]`` blocks read by the native threaded prefetcher
    (:mod:`.native`), so the streaming fold overlaps disk reads with
    device work.
    """

    directory: str
    nbrick: int
    n_brick: int
    brick_size: float  # box length of one brick
    fmt: str = "npz"
    device: str = "cuda"

    @property
    def total_n(self) -> int:
        return self.nbrick * self.n_brick

    @property
    def total_box(self) -> float:
        return self.nbrick * self.brick_size

    @classmethod
    def from_particles(
        cls,
        directory: str,
        particles: Particles,
        nbrick: int,
        n_brick: int,
        method: str = "nn",
        margin_cells: int = 4,
        fmt: str = "npz",
        **deposit_kwargs,
    ) -> "BrickStore":
        """Interpolate particles brick by brick (reference
        ``interp.py:344-421``): per brick, select the particles within a
        +-h margin, shift them to the padded brick's origin, deposit the
        padded grid (``periodic=False`` for ``nn`` and ``sph``), trim the
        margin, save.  The store's device is the particles'."""
        from ..run.pipeline import deposit as deposit_dispatch

        os.makedirs(directory, exist_ok=True)
        brick_size = particles.box_size / nbrick
        margin = margin_cells * (brick_size / n_brick)
        n_padded = n_brick + 2 * margin_cells

        pos = particles.pos.cpu().numpy()
        h = particles.smoothing_length().cpu().numpy()
        store = cls(directory, nbrick, n_brick, brick_size, fmt,
                    device=str(particles.pos.device))
        extra = {"periodic": False} if method in ("nn", "sph") else {}
        for r in range(nbrick):
            for s in range(nbrick):
                for t in range(nbrick):
                    lo = np.array([r, s, t]) * brick_size - margin
                    hi = lo + brick_size + 2 * margin
                    sel = np.all((pos + h[:, None] >= lo)
                                 & (pos - h[:, None] < hi), axis=1)
                    sub = particles[np.where(sel)[0]]
                    sub = dataclasses.replace(
                        sub, pos=sub.pos - torch.tensor(
                            lo, dtype=sub.pos.dtype, device=sub.pos.device),
                        box_size=float(brick_size + 2 * margin))
                    field = deposit_dispatch(sub, n_padded, method=method,
                                             **extra, **deposit_kwargs)
                    store.save_brick(r, s, t,
                                     field.trim(margin_cells, n_brick))
        store.save()
        return store

    def _raw_path(self, r: int, s: int, t: int) -> str:
        return os.path.join(self.directory, f"brick_field_loc{r}_{s}_{t}.bin")

    @property
    def _floats_per_brick(self) -> int:
        return self.n_brick**3 * 4  # [vx, vy, vz, mass]

    def save_brick(self, r: int, s: int, t: int, field: BoxField) -> None:
        velocity = field.velocity.cpu().numpy()
        mass = field.mass.cpu().numpy()
        if self.fmt == "raw":
            from . import native

            native.brick_write_raw(self._raw_path(r, s, t),
                                   np.concatenate([velocity, mass[None]]))
            return
        np.savez(_brick_path(self.directory, r, s, t), velocity=velocity,
                 mass=mass)

    def _field(self, velocity: np.ndarray, mass: np.ndarray) -> BoxField:
        return BoxField.from_numpy(velocity, mass,
                                   self.brick_size / self.n_brick,
                                   device=self.device)

    def _field_from_flat(self, flat: np.ndarray) -> BoxField:
        nb = self.n_brick
        data = flat.reshape(4, nb, nb, nb)
        return self._field(data[:3], data[3])

    def __getitem__(self, loc: Tuple[int, int, int]) -> BoxField:
        """Lazy brick load (reference ``interp.py:867-879``)."""
        r, s, t = loc
        if self.fmt == "raw":
            from . import native

            return self._field_from_flat(native.brick_read_raw(
                self._raw_path(r, s, t), self._floats_per_brick))
        with np.load(_brick_path(self.directory, r, s, t)) as z:
            return self._field(z["velocity"], z["mass"])

    def _brick_stream(self):
        """Bricks in (r, s, t) order; with ``fmt='raw'`` and the native
        runtime present, brick i+1 is read on a worker thread while
        brick i is processed (the reference read them one after the
        other, ``interp.py:900-907``)."""
        locs = [(r, s, t) for r in range(self.nbrick)
                for s in range(self.nbrick) for t in range(self.nbrick)]
        prefetch = False
        if self.fmt == "raw":
            from . import native

            prefetch = native.native_available()
        if not prefetch:
            for loc in locs:
                yield loc, self[loc]
            return
        pf = native.BrickPrefetcher()
        try:
            pf.start(self._raw_path(*locs[0]), self._floats_per_brick)
            for i, loc in enumerate(locs):
                flat = pf.finish(self._floats_per_brick)
                if i + 1 < len(locs):
                    pf.start(self._raw_path(*locs[i + 1]),
                             self._floats_per_brick)
                yield loc, self._field_from_flat(flat)
        finally:
            pf.close()

    def save(self) -> None:
        with open(os.path.join(self.directory, "brick_decomp.json"),
                  "w") as f:
            json.dump({"nbrick": self.nbrick, "n_brick": self.n_brick,
                       "brick_size": self.brick_size, "fmt": self.fmt}, f)

    @classmethod
    def load(cls, directory: str, device="cuda") -> "BrickStore":
        with open(os.path.join(directory, "brick_decomp.json")) as f:
            meta = json.load(f)
        return cls(directory, meta["nbrick"], meta["n_brick"],
                   meta["brick_size"], meta.get("fmt", "npz"),
                   device=str(device))

    def fold(
        self,
        m: int,
        beta: Sequence[int],
        quantity: str = "velocity",
        n_result: Optional[int] = None,
    ) -> FoldedField:
        """Stream bricks from disk into one folded (n_result)^3 field
        (reference ``BrickInventory.fold``, ``interp.py:882-946``):
        *fold-stitch* when ``m >= nbrick`` (each brick folds by ``m /
        nbrick`` and accumulates), *stitch-fold* when ``m < nbrick``
        (each phased brick lands in its mosaic slot); mass-weighted
        down-sampling when ``n_result < total_n / m``; the ``m^-1.5``
        normalization last."""
        beta = tuple(int(b) for b in beta)
        if n_result is None:
            n_result = self.total_n // m
            n_down = 1
        else:
            n_down = (self.total_n // m) // n_result
            if n_down == 0:
                raise ValueError(
                    "The folded size total_n/m must be a multiple of "
                    "n_result.")
        lead = (3,) if quantity in ("velocity", "momentum") else ()
        acc = torch.zeros(lead + (n_result,) * 3, dtype=torch.complex64,
                          device=self.device)
        total_n_eff = self.total_n // n_down
        for (r, s, t), brick in self._brick_stream():
            if n_down > 1:
                brick = brick.down_sample(n_down)
            nb = brick.n_grid
            if quantity == "velocity":
                data = brick.velocity
            elif quantity == "momentum":
                data = brick.momentum()
            elif quantity == "energy":
                data = brick.kinetic_energy()
            else:
                raise ValueError(f"Unsupported quantity {quantity!r}")
            phase = get_phase(beta, total_n=total_n_eff, n_local=nb,
                              offset=(r * nb, s * nb, t * nb),
                              device=data.device)
            phased = apply_phase(data.to(torch.complex64), phase)
            if m >= self.nbrick:
                if m % self.nbrick:
                    raise ValueError(
                        "m must be a multiple of nbrick for fold-stitch")
                acc = acc + fold_field(phased, m // self.nbrick)
            else:
                u = self.nbrick // m
                w = n_result // u
                acc[..., (r % u) * w:(r % u + 1) * w,
                    (s % u) * w:(s % u + 1) * w,
                    (t % u) * w:(t % u + 1) * w] += phased
        return FoldedField(field=acc / m**1.5, fold_factor=m, beta=beta,
                           box_size=self.total_box / m,
                           total_box_size=self.total_box)
