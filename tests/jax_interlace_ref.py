"""Interlaced spectra composed from the JAX package's own parts, with the
rotation of the shifted deposit's transform as an argument.

Interlacing deposits the particles a second time shifted by +h/2 per
axis.  With the forward transform ``F(k) = sum rho(x) e^{-i k.x}`` the
shift multiplies a true mode by ``e^{-i theta}``, ``theta = pi (Kx + Ky
+ Kz) / N_total``, so the two transforms line up under ``0.5 (F1 +
e^{+i theta} F2)``.  The JAX package combines ``0.5 (F1 + e^{-i theta}
F2)`` (ROADMAP fault F8, kept there as the reference); the port
rotates by ``e^{+i theta}``.

Each function here repeats one interlaced pipeline of the JAX package
step by step (its deposits, fold targets, compensation and binning) and
calls JAX's ``interlaced_power_from_complex``, which rotates by
``e^{-i theta_arg}``, with ``theta_arg = -rotation * theta``:
``rotation=-1`` is the JAX package's own pipeline (the tests hold the
composition to it), ``rotation=+1`` the corrected one (the tests hold
the port to it).  Nothing in the JAX package is patched.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from vpower_tpu.run import pipeline as jpipe
from vpower_tpu.spectrum import fold as jfold
from vpower_tpu.spectrum import power as jpower
from vpower_tpu.spectrum.spectrum import PowerSpectrum


def _wrapped(n_grid):
    idx = jax.lax.iota(jnp.int32, n_grid)
    return jnp.where(idx < (n_grid + 1) // 2, idx, idx - n_grid)


def lattice_angle(n_grid, dtype=jnp.float32):
    """``theta = pi (nx + ny + nz) / N`` on the unfolded mode lattice, as
    the JAX package's ``interlaced_vector_power`` builds it."""
    t = jnp.pi * _wrapped(n_grid).astype(dtype) / n_grid
    return t[:, None, None] + t[None, :, None] + t[None, None, :]


@partial(jax.jit, static_argnames=("n_grid", "method", "quantity",
                                   "comp_order", "rotation"))
def _power_spectrum(p1, p2, n_grid, method, quantity, comp_order, rotation):
    """``vpower_tpu.run.pipeline.power_spectrum``'s interlaced ``run``."""
    f1 = jpipe._deposit_scatter(p1, n_grid, method)
    f2 = jpipe._deposit_scatter(p2, n_grid, method)
    d1, d2 = jpipe._quantity_grid(f1, quantity), jpipe._quantity_grid(
        f2, quantity)
    if d1.ndim == 3:
        d1, d2 = d1[None], d2[None]
    p_grid = jpower.interlaced_power_from_complex(
        jax.lax.complex(d1, jnp.zeros_like(d1)),
        jax.lax.complex(d2, jnp.zeros_like(d2)), f1.box_size,
        -rotation * lattice_angle(n_grid, d1.dtype))
    if comp_order > 0:
        p_grid = p_grid * jpower.window_compensation(n_grid, comp_order,
                                                     dtype=p_grid.dtype)
    return jpower.shell_bin(p_grid, f1.box_size)


def power_spectrum(pj, n_grid, method, quantity, compensate=False,
                   rotation=+1):
    """``power_spectrum(pj, n_grid, method, quantity, interlace=True,
    compensate=compensate)`` of the JAX package, rotating by ``e^{i
    rotation theta}``."""
    comp_order = {"ngp": 1, "cic": 2}[method] if compensate else 0
    cell = pj.box_size / n_grid
    shifted = dataclasses.replace(pj, pos=(pj.pos + cell / 2) % pj.box_size)
    k, psum, nsample = _power_spectrum(pj, shifted, n_grid, method, quantity,
                                       comp_order, rotation)
    return PowerSpectrum.from_binned(np.asarray(k), np.asarray(psum),
                                     np.asarray(nsample))


@partial(jax.jit, static_argnames=("n_grid", "m", "method", "comp_order",
                                   "rotation", "mesh_bins"))
def _fused(pj, beta, n_grid, m, method, comp_order, rotation, mesh_bins):
    """One beta of ``_fused_fold_sweep_device``'s ``one_beta`` (or, with
    ``mesh_bins``, of the mesh runner's), on the whole folded grid."""
    box = pj.box_size
    folded_box = box / m
    n_total = m * n_grid
    values = pj.vel * pj.mass[:, None]
    beta_f = beta.astype(jnp.float32)

    def fold_grid(pos):
        ids, vals, idx_full = jfold.fold_scatter_targets(
            pos, values, m, box, n_grid, method=method)
        phase = (2.0 * jnp.pi / n_total) * (idx_full.astype(jnp.float32)
                                             @ beta_f)
        shape = (vals.shape[1],) + (n_grid,) * 3
        re, im = (jax.ops.segment_sum(w[:, None] * vals, ids,
                                      num_segments=n_grid**3).T.reshape(shape)
                  for w in (jnp.cos(phase), -jnp.sin(phase)))
        return jax.lax.complex(re, im)

    grid = fold_grid(pj.pos)
    grid2 = fold_grid((pj.pos + box / n_total / 2.0) % box)
    kf = [m * _wrapped(n_grid).astype(grid.real.dtype)
          + beta[a].astype(grid.real.dtype) for a in range(3)]
    theta = (jnp.pi / n_total) * (kf[0][:, None, None] + kf[1][None, :, None]
                                  + kf[2][None, None, :])
    p_grid = jpower.interlaced_power_from_complex(
        grid, grid2, folded_box, -rotation * theta)
    if comp_order > 0:
        x = [jnp.pi * k / n_total for k in kf]
        s = [jnp.where(xi != 0, jnp.sin(xi) / jnp.where(xi != 0, xi, 1.0),
                       1.0) ** comp_order for xi in x]
        w = s[0][:, None, None] * s[1][None, :, None] * s[2][None, None, :]
        p_grid = p_grid / (w * w)
    kshift = 2.0 * jnp.pi * beta.astype(p_grid.dtype) / box
    if mesh_bins:
        kmin, kmax, spacing, _ = jpower.default_k_bins(box,
                                                       folded_box / n_grid)
        return jpower.shell_bin_local(p_grid, n_grid, folded_box,
                                      jnp.zeros((3,), jnp.int32), kmin=kmin,
                                      kmax=kmax, spacing=spacing,
                                      kshift=kshift)
    kmin = 2.0 * np.pi / box
    n_bins = int((np.pi / (box / n_total) - kmin) / kmin) + 1
    bins = jpower.bin_grid_local(p_grid.shape, n_grid, folded_box, kmin,
                                 kmin, n_bins, jnp.zeros((3,), jnp.int32),
                                 kshift, dtype=p_grid.dtype)
    psum, nsample = jpower._cascade_bin(p_grid, bins, n_bins)
    return (kmin + kmin * jnp.arange(n_bins, dtype=p_grid.dtype), psum,
            nsample)


def fused_fold_spectrum(pj, n_grid, m, beta, method, compensate=False,
                        rotation=+1):
    """``fused_fold_spectrum(pj, n_grid, m, beta, method, interlace=True,
    compensate=compensate)`` of the JAX package, rotating by ``e^{i
    rotation theta}``."""
    beta = tuple(int(b) for b in beta)
    comp_order = {"ngp": 1, "cic": 2}[method] if compensate else 0
    k, psum, nsample = _fused(pj, jnp.asarray(beta, jnp.int32), n_grid, m,
                              method, comp_order, rotation, False)
    return PowerSpectrum.from_binned(np.asarray(k), np.asarray(psum),
                                     np.asarray(nsample), m=m, beta=beta)


def mesh_spectrum(pj, n_grid, method, fold=None, compensate=False,
                  rotation=+1):
    """``vpower_tpu.parallel.distributed_spectrum(pj, n_grid, mesh,
    method, quantity="momentum", fold=fold, interlace=True,
    compensate=compensate)``, its binning included, on one device
    (the unfolded flags take the fused route at m = 1, beta 0, as the
    mesh does)."""
    m, beta = (1, (0, 0, 0)) if fold is None else (
        int(fold[0]), tuple(int(b) for b in fold[1]))
    comp_order = {"ngp": 1, "cic": 2}[method] if compensate else 0
    k, psum, nsample = _fused(pj, jnp.asarray(beta, jnp.int32), n_grid, m,
                              method, comp_order, rotation, True)
    return PowerSpectrum.from_binned(
        np.asarray(k), np.asarray(psum), np.asarray(nsample),
        m=m if fold else 0, beta=beta if fold else (-1, -1, -1))
