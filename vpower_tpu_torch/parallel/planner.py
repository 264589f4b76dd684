"""Run planner: (target resolution, devices, device memory) -> (mesh,
grid, fold).

PyTorch counterpart of :mod:`vpower_tpu.parallel.planner` (the
reference's planner, ``scripts/parallel_optimized.py:70-88``, factorized
``NTOT = threads_per_axis * Nbox * loops_per_axis`` under a memory cap
``MAXNBOX``).  The factorization is ``NTOT = fold_m * n_grid`` with the
per-device peak estimated from the ACTUAL pipeline that will run
(scatter / fused-fold sweep / block-streamed gather): grid cubes and
particle-proportional target buffers are modeled separately, and real vs
complex (folded) pipelines carry different cube counts.

The model's terms, routing predicate, divisibility rule and fold loop
are the JAX package's; its constants are the port's, taken from the
port's measured peaks on an H100 (the JAX package's are the TPU's: they
under-predict the port's NN peak 2x and plan an unfolded 1024^3 NN grid
that the card cannot hold).  The unfolded scatter kind spans
methods whose peaks differ several-fold, so its cube count is a table
by method.  Measured peaks calibrate later plans through a file of the
port's own, never the JAX package's, so TPU and H100 ratios never mix.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .mesh import mesh_shape_for

__all__ = [
    "Plan", "plan_run", "estimate_peak_bytes", "device_hbm_bytes",
    "record_measured_peak", "calibration_factor", "streamed_pipeline",
]


def streamed_pipeline(method: str, quantity: str, fold_m: int) -> bool:
    """THE routing predicate: does a run stream the full-resolution
    lattice in blocks (``streamed_folded_sweep``) instead of the fused
    fold scatter?  Owned here so the planner's memory model, the
    ``Plan`` the user confirms, and the CLI's execution can never
    disagree.  Fused folding exists only for the scatter momentum
    pipeline (NGP/CIC deposit of ``m * v`` with phase weights,
    ``run/pipeline.py:fused_fold_spectrum``); every other folded
    combination — gather (NN) deposition, SPH, or a derived quantity
    whose nonlinearity must be applied at full resolution — streams."""
    return fold_m > 1 and not (
        method in ("ngp", "cic") and quantity == "momentum"
    )

# Simultaneously-live n_grid^3 float32 cubes by pipeline (deposited
# grids + FFT in/out + power + binning transients), fitted so that the
# estimate of each route of the CLI at 512^3 and 10,077,696
# particles lies at 1.17-1.65x its measured peak (``max_memory_allocated``
# with the particles held; ``tools/cli_peaks.py``, NVIDIA H100 80GB
# HBM3, 700 W).  Unfolded scatter, by method ("nn" covers the
# exact path too: ``plan_run`` has no ``exact`` argument):
_CUBES_REAL = {
    "ngp": 15.0,  # measured peak 6.814 GiB, estimate 8.25
    "cic": 10.0,  # measured peak 6.814 GiB, estimate 8.38 (8 targets)
    "nn": 25.0,   # measured peak 10.978 GiB, exact 7.847; estimate 12.88
    "sph": 16.0,  # measured peak 6.814 GiB, estimate 8.38
}
# Complex folded grids (the fused sweep; the streamed finish takes two
# sets): the fused sweep at m = 2, 512^3, measured peak 7.096 GiB,
# estimate 8.98
_CUBES_COMPLEX = 16.0
# Streamed gather path: B folded accumulators as (re, im) f32 pairs per
# channel + the per-block working set (the extended NN descent's state,
# seeds and pyramid a cell of the extended grid), handled separately:
# range 2048 (256^3 folded, 320^3 blocks, 8 betas a pass), measured
# peak 7.930 GiB, estimate 9.30
_NN_BYTES_PER_CELL = 120.0

_DEFAULT_HBM = 16e9

# ---------------------------------------------------------------------- #
# measured-peak calibration                                              #
# ---------------------------------------------------------------------- #
# The constants above are estimates; the CLI records measured peaks per
# (pipeline, n_grid, n_devices) here, and later plans scale their
# prediction by the median measured/predicted ratio of the same pipeline
# kind.  A wrong constant then self-corrects after one run instead of
# silently over-folding or running out of memory.
_CALIB_PATH = os.environ.get(
    "VPOWER_CALIB_PATH",
    os.path.join(os.path.expanduser("~"), ".cache", "vpower_tpu_torch",
                 "planner_calib.json"),
)


def _pipeline_kind(method: str, quantity: str, fold_m: int) -> str:
    if streamed_pipeline(method, quantity, fold_m):
        return "streamed"
    return "fused" if fold_m > 1 else "scatter"


def _load_calib() -> dict:
    try:
        with open(_CALIB_PATH) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def record_measured_peak(plan: "Plan", measured_bytes: float) -> None:
    """Persist one measured/predicted data point for the plan's pipeline
    kind (keyed by grid size and device count; last write wins)."""
    if not measured_bytes or plan.bytes_per_device <= 0:
        return
    calib = _load_calib()
    kind = _pipeline_kind(plan.method, plan.quantity, plan.fold_m)
    key = f"{kind}:{plan.n_grid}:{int(np.prod(plan.mesh_shape))}"
    calib[key] = {
        "measured": float(measured_bytes),
        "predicted": float(plan.bytes_per_device),
    }
    try:
        os.makedirs(os.path.dirname(_CALIB_PATH), exist_ok=True)
        tmp = _CALIB_PATH + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(calib, fh, indent=1)
        os.replace(tmp, _CALIB_PATH)
    except OSError:
        pass  # calibration is best-effort; never fail a run over it


def calibration_factor(kind: str) -> float:
    """Median measured/predicted ratio for a pipeline kind, clamped to
    [0.5, 4] so one bad record cannot wreck planning; 1.0 when no
    measurements exist."""
    ratios = [
        v["measured"] / v["predicted"]
        for k, v in _load_calib().items()
        if k.startswith(kind + ":") and v.get("predicted")
    ]
    if not ratios:
        return 1.0
    return float(np.clip(np.median(ratios), 0.5, 4.0))


def device_hbm_bytes(device="cuda") -> float:
    """Per-device memory budget: the card's total memory, or the JAX
    package's 16 GB default for a device that is not a card (so CPU
    plans equal the JAX package's CPU plans)."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return _DEFAULT_HBM


def measured_peak_bytes(device="cuda") -> Optional[float]:
    """The card's peak allocated bytes since the process started (or the
    last ``torch.cuda.reset_peak_memory_stats``), else None — callers
    print predicted-vs-measured after the first beta."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return float(torch.cuda.max_memory_allocated(device)) or None


def estimate_peak_bytes(
    n_grid: int,
    n_devices: int,
    n_particles: int,
    method: str = "ngp",
    quantity: str = "momentum",
    fold_m: int = 1,
    beta_batch: int = 1,
    margin_cells: Optional[int] = None,
    certify: bool = True,
) -> int:
    """Per-device peak estimate (bytes) of the pipeline the CLI would
    run for this configuration.

    Streamed pipelines keep the FULL folded accumulators + per-block
    working set on every device (a mesh parallelizes over blocks, not
    grid cells); what divides by ``n_devices`` is the NN candidate-row
    array, partitioned by block ownership."""
    ndev = max(n_devices, 1)
    streamed = streamed_pipeline(method, quantity, fold_m)

    if streamed:
        n_ch = 1 if quantity == "energy" else 3
        cells_full = float(n_grid) ** 3
        grid_bytes = cells_full * 4 * (
            2 * n_ch * beta_batch + 2 * _CUBES_COMPLEX
        )
        particle_bytes = n_particles * 10 * 4  # raw arrays (scatter)
        if method == "nn":
            from ..run.streamed import (
                _default_margin_cells, _round_ext_capped, round_ext,
            )

            if margin_cells is None and certify:
                # mirror the sweep's certified density-aware default
                want = _default_margin_cells(
                    n_grid, fold_m * n_grid, n_particles
                )
                n_ext, _ = _round_ext_capped(
                    n_grid, want, (fold_m * n_grid - n_grid) // 2
                )
            else:
                mc = margin_cells if margin_cells is not None else max(
                    n_grid // 4, 8
                )
                n_ext, _ = round_ext(n_grid, mc)
            grid_bytes += n_ext**3 * _NN_BYTES_PER_CELL
            # candidate rows: Np scaled by the periodic-image/margin
            # expansion, sharded over devices, 25% imbalance slack
            expansion = (n_ext / n_grid) ** 3
            particle_bytes = n_particles * expansion * 28.0 / ndev * 1.25
        return int(
            (particle_bytes + grid_bytes) * calibration_factor("streamed")
        )

    cells = n_grid**3 / ndev
    # particle-proportional working set
    targets_per_particle = 8 if method == "cic" else 1
    n_local = n_particles / ndev * (
        1.5 if n_devices > 1 else 1.0  # bucket-padding slack
    )
    particle_bytes = n_local * 10 * 4  # pos+vel+mass+density+values
    if fold_m > 1:
        # fused sweep: sorted (ids, weighted values, qidx) target rows
        particle_bytes += n_local * targets_per_particle * (4 + 16 + 12) * 2
    elif method in ("ngp", "cic"):
        particle_bytes += n_local * targets_per_particle * (4 + 16) * 2

    if fold_m > 1:
        grid_bytes = cells * 4 * _CUBES_COMPLEX
        factor = calibration_factor("fused")
    else:
        grid_bytes = cells * 4 * _CUBES_REAL[method]
        factor = calibration_factor("scatter")
    return int((particle_bytes + grid_bytes) * factor)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A validated execution plan (the reference printed its plan and
    asked for confirmation, ``parallel_optimized.py:238-245``; we return
    it as data)."""

    n_total: int            # target dynamic range (NTOT)
    n_grid: int             # deposited grid size per beta (Nbox analog)
    fold_m: int             # fold factor (m)
    mesh_shape: Tuple[int, int]
    n_betas: int            # sub-spectra to compute (m^3 for full sweep)
    bytes_per_device: int   # estimated peak
    hbm_bytes: int          # budget the plan was made against
    n_particles: int
    method: str = "ngp"
    quantity: str = "momentum"

    @property
    def streamed(self) -> bool:
        return streamed_pipeline(self.method, self.quantity, self.fold_m)

    def describe(self) -> str:
        px, py = self.mesh_shape
        pipe = (
            "block-streamed gather" if self.streamed
            else ("fused-fold sweep" if self.fold_m > 1 else "scatter")
        )
        return (
            f"Planner: NTOT={self.n_total} = fold {self.fold_m} x grid "
            f"{self.n_grid}, mesh {px}x{py} ({px * py} chips), "
            f"{self.n_betas} beta sub-spectra, {pipe} pipeline, "
            f"predicted peak ~{self.bytes_per_device / 2**30:.2f} GiB/chip "
            f"of {self.hbm_bytes / 2**30:.1f} GiB HBM."
        )


def plan_run(
    n_total: int,
    n_devices: int,
    hbm_bytes: Optional[float] = None,
    n_particles: int = 0,
    max_n_grid: Optional[int] = None,
    beta_subsample: Optional[int] = None,
    method: str = "ngp",
    quantity: str = "momentum",
    beta_batch: int = 1,
    margin_cells: Optional[int] = None,
    certify: bool = True,
) -> Plan:
    """Choose (n_grid, fold_m, mesh) for a target resolution.

    Mirrors the reference's constraints: the grid must divide the
    resolution evenly (``parallel_optimized.py:76-83``) and the
    estimated peak of the pipeline that will actually run must fit the
    per-device memory budget (the card's total memory when
    ``hbm_bytes`` is not given).  Unlike the reference, the device count
    need not be a perfect cube — any (px, py) factorization works for
    pencil decomposition.
    """
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes()
    mesh_shape = mesh_shape_for(n_devices)
    px, py = mesh_shape
    budget = 0.9 * hbm_bytes

    fold_m = 1
    while True:
        if n_total % fold_m == 0:
            n_grid = n_total // fold_m
            # streamed pipelines run block-parallel whenever the m^3
            # blocks divide over the devices (run/cli.py routing),
            # else on one device
            streamed = streamed_pipeline(method, quantity, fold_m)
            if streamed:
                n_dev_eff = (
                    n_devices if fold_m**3 % max(n_devices, 1) == 0 else 1
                )
            else:
                n_dev_eff = n_devices
            peak = estimate_peak_bytes(
                n_grid, n_dev_eff, n_particles, method=method,
                quantity=quantity, fold_m=fold_m, beta_batch=beta_batch,
                margin_cells=margin_cells, certify=certify,
            )
            fits = peak <= budget
            divisible = streamed or (
                (n_grid % px == 0) and (n_grid % py == 0)
            )
            small_enough = max_n_grid is None or n_grid <= max_n_grid
            if fits and divisible and small_enough:
                break
        fold_m += 1
        if fold_m > n_total:
            raise ValueError(
                f"No feasible plan for NTOT={n_total} on {n_devices} "
                f"devices with {hbm_bytes / 2**30:.1f} GiB HBM."
            )

    n_betas = beta_subsample if beta_subsample is not None else fold_m**3
    return Plan(
        n_total=n_total,
        n_grid=n_total // fold_m,
        fold_m=fold_m,
        mesh_shape=mesh_shape,
        n_betas=int(n_betas),
        bytes_per_device=int(peak),
        hbm_bytes=int(hbm_bytes),
        n_particles=n_particles,
        method=method,
        quantity=quantity,
    )
