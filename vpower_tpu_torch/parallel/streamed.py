"""Block-parallel streamed folded sweep across a device mesh.

PyTorch counterpart of :mod:`vpower_tpu.parallel.streamed`, with its
signature.  It distributes the memory-bounded folded pipeline of
:func:`vpower_tpu_torch.run.streamed.streamed_folded_sweep` — the
reference's canonical workload (folded *velocity* spectra from
particles, ``scripts/parallel_optimized.py:337-398``) — over the entries
of a :class:`~vpower_tpu_torch.parallel.mesh.Mesh`: the m^3
full-resolution blocks are independent until the fold accumulation, so
entry g deposits or NN-gathers only its ``m^3 / n_entries`` blocks
``g * nb_local ... (g + 1) * nb_local - 1`` and phase-accumulates them
for every beta of the batch; ONE reduction combines the folded
accumulators.  This replaces the reference's per-buffer ``allgather`` of
query results (``parallel_optimized.py:365-368``) with a single
reduction of the already-folded O(n_grid^3) field.

The reduction stands for the JAX package's ``psum``: the local entries'
partial sums are added onto the first local entry's device in entry
order, one at a time, and on a mesh with a process group (one that
spans processes, :func:`~vpower_tpu_torch.parallel.multihost.global_mesh`)
the process-local sums are ``all_reduce``d over it, so every process
gets the same spectra.  ``all_reduce`` is the only collective:
of the accumulators once a batch, and of the per-block suspect counts
once a sweep (the JAX package ``psum``s both).

One Python loop over the entries launches the blocks asynchronously and
settles once a batch.  NN candidate rows are partitioned by block owner
into equal-size, zero-padded shards, one on each entry's device (the
per-rank memory bound of the reference's gen-2/4 designs,
``scripts/parallel_disk.py:67-85``); the scatter methods replicate the
raw particle arrays, which are O(Np).
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.particles import Particles
from ..run import streamed as run_streamed
from ..spectrum.spectrum import SpectrumList, init_beta_space

__all__ = ["distributed_streamed_sweep"]


def _combine(mesh, parts):
    """What stands for ``psum``: ``parts`` (one tensor a local entry, in
    entry order) summed onto the first one, in place, one at a time;
    then, on a mesh with a process group, ``all_reduce``d over it."""
    out = parts[0]
    for p in parts[1:]:
        out.add_(p.to(out.device))
    if mesh.group is not None:
        torch.distributed.all_reduce(out, group=mesh.group)
    return out


def _shard_candidates(rows, starts, counts, pad, n_entries, nb_local,
                      local_devices):
    """Partition the per-block candidate runs by block owner: entry g's
    shard holds ONLY its blocks' runs, zero-padded to one size ``r_dev``
    for every entry, on ``local_devices[g]`` (the entries of this
    process).  Returns ``(shards {g: (r_dev, 7)}, starts_dev (n_entries,
    nb_local) within a shard, counts_dev, r_dev)``."""
    counts_dev = np.asarray(counts, np.int64).reshape(n_entries, nb_local)
    dev_tot = counts_dev.sum(axis=1)
    r_dev = int(dev_tot.max()) + pad
    starts_dev = np.empty((n_entries, nb_local), np.int64)
    shards = {}
    for g in range(n_entries):
        q0 = g * nb_local
        seg0 = int(starts[q0])
        starts_dev[g] = np.asarray(starts[q0:q0 + nb_local]) - seg0
        if g in local_devices:
            dv = local_devices[g]
            shard = torch.zeros((r_dev, rows.shape[1]), dtype=rows.dtype,
                                device=dv)
            shard[:int(dev_tot[g])] = rows[seg0:seg0 + int(dev_tot[g])].to(dv)
            shards[g] = shard
    return shards, starts_dev, counts_dev, r_dev


def distributed_streamed_sweep(
    particles: Particles,
    n_grid: int,
    m: int,
    mesh,
    quantity: str = "velocity",
    method: str = "nn",
    beta_sequence: Optional[np.ndarray] = None,
    beta_batch: int = 4,
    margin_cells: Optional[int] = None,
    exact: bool = False,
    certify: bool = True,
    on_spectrum=None,
    cache_values: Optional[bool] = None,
    stage_times: Optional[dict] = None,
) -> SpectrumList:
    """Folded sub-spectra of a derived field over ``mesh``, block-
    parallel.  Requires ``m**3 % n_entries == 0`` (whole blocks per
    entry).  Results equal the single-card
    :func:`~vpower_tpu_torch.run.streamed.streamed_folded_sweep` (same
    block values) to float32 rounding: the accumulation order differs.

    ``exact=True`` with NN on a single-process mesh routes through
    round-robin block placement
    (:func:`~vpower_tpu_torch.run.streamed.streamed_folded_sweep` with
    ``devices=``): the window sweep's tier decisions are read on the
    host block by block, so exact mode places block q on entry ``q %
    n_entries`` — full window exactness, margin certificates AND
    per-block escalation, with no divisibility constraint.  On a mesh
    that spans processes exact NN runs the ring-refined index path on
    each process's own blocks, with a warning.

    ``cache_values`` (default: auto by per-entry memory): compute every
    local block's field values ONCE into a cache on each entry's device
    — (nb_local, C, n_grid^3) float32 — so each beta batch is a local
    matmul and one reduction instead of a full NN / deposit pass (the
    role the reference's gen-2 disk index buffers played,
    ``scripts/parallel_disk.py:305-332``: query once, reuse per pass).
    Auto-enables when the per-entry cache is <= ~2 GB; pass False to
    force per-batch recompute (O(beta_batch * n_grid^3) device memory).

    ``certify=True``: the compute pass yields a PER-BLOCK suspect-cell
    count.  With the value cache on a single-process mesh, offending
    blocks are escalated at doubled margins exactly like the single-card
    sweep — their cache column is zeroed and the corrected values ride
    each batch as a correction term added after the reduction.  Without
    the cache (or on a multi-process mesh), the count WARNS and the run
    proceeds (rerun with a larger ``margin_cells`` if it fires).

    ``stage_times``: dict out-param; receives ``suspect_cells``,
    ``escalated_blocks``, ``uncertified_cells`` (certificate stats) and,
    with the cache, ``compute_s`` / ``batches_s`` wall splits."""
    devs = np.asarray(mesh.devices).reshape(-1)
    ndev = devs.size
    procs = mesh.process_ids.reshape(-1)
    me = mesh.process_index
    single_controller = bool((procs == me).all())

    if exact and method == "nn":
        if single_controller:
            return run_streamed.streamed_folded_sweep(
                particles, n_grid, m, quantity=quantity, method=method,
                beta_sequence=beta_sequence, beta_batch=beta_batch,
                margin_cells=margin_cells, exact=True, certify=certify,
                devices=list(devs), on_spectrum=on_spectrum,
                stage_times=stage_times,
            )
        warnings.warn(
            "multi-host mesh: exact NN runs the ring-refine path on each "
            "process's own blocks (the window sweep's round-robin "
            "placement needs every entry addressable from one process); "
            "the certificate below counts any cell it cannot prove.",
            stacklevel=2,
        )

    n_blocks = m**3
    if n_blocks % ndev != 0:
        raise ValueError(
            f"m^3 = {n_blocks} blocks must divide over {ndev} devices"
        )
    nb_local = n_blocks // ndev
    local = [g for g in range(ndev) if procs[g] == me]
    local_devs = {g: torch.device(devs[g]) for g in local}
    dev0 = local_devs[local[0]]

    if beta_sequence is None:
        beta_sequence = init_beta_space(m)
    betas_np = np.asarray(beta_sequence, np.int32).reshape(-1, 3)
    box = float(particles.box_size)
    n_total = m * n_grid
    n_ch = 1 if quantity == "energy" else 3
    n_cells = n_grid**3
    cell_total = box / n_total

    if method == "nn":
        # the single-card block source (the suspect count warns if the
        # margin ever binds where no escalation runs)
        n_ext, margin_cells, rows, starts, counts, pad = \
            run_streamed._nn_block_source(particles, m, n_grid,
                                          margin_cells, certify)
        shards, starts_dev, counts_dev, _ = _shard_candidates(
            rows, starts, counts, pad, ndev, nb_local, local_devs)
        del rows
        ext_box_grid = n_ext * cell_total

        def block_values(g, i):
            s0 = int(starts_dev[g, i])
            out = run_streamed._nn_block_values(
                shards[g][s0:s0 + pad], int(counts_dev[g, i]), n_grid,
                n_ext, margin_cells, float(ext_box_grid), float(cell_total),
                quantity, exact, certify=certify)
            if certify:
                return out[0].reshape(n_ch, n_cells), out[1]
            return out.reshape(n_ch, n_cells), None

    elif method in ("ngp", "cic", "sph"):
        # raw particle arrays are O(Np), small next to the candidate
        # runs: one replica on each device that holds an entry here
        h = particles.smoothing_length() if method == "sph" else None
        replicas = {}
        for dv in local_devs.values():
            if dv not in replicas:
                replicas[dv] = (particles.pos.to(dv), particles.vel.to(dv),
                                particles.mass.to(dv),
                                None if h is None else h.to(dv))

        def block_values(g, i):
            pos, vel, mass, h_d = replicas[local_devs[g]]
            q3 = run_streamed._block_q3(g * nb_local + i, m)
            return run_streamed._scatter_block_values(
                pos, vel, mass, q3, n_grid, n_total, box, method, quantity,
                h=h_d).reshape(n_ch, n_cells), None

    else:
        raise ValueError(f"Unsupported method {method!r}")

    if cache_values is None:
        # auto: a cache of nb_local blocks of f32 values on each entry
        cache_values = nb_local * n_ch * n_cells * 4 <= 2e9

    def phases(batch, g, zero=()):
        """Entry g's (B, nb_local) phases as f32 (re, im) on its device,
        its blocks ``zero`` at 0."""
        return run_streamed._s_phases(
            batch, range(g * nb_local, (g + 1) * nb_local), m,
            local_devs[g], [q - g * nb_local for q in zero
                            if q // nb_local == g])

    def suspects(sus):
        """The (m^3,) per-block suspect counts on the host, from the
        local entries' ``{g: (nb_local,) tensor}``, summed over the
        processes."""
        vec = torch.zeros((n_blocks,), dtype=torch.int64, device=dev0)
        for g in local:
            vec[g * nb_local:(g + 1) * nb_local] = sus[g].to(dev0)
        return _combine(mesh, [vec]).cpu().numpy()

    stats = {"suspect_cells": 0, "escalated_blocks": 0,
             "uncertified_cells": 0}
    spectra = []

    if cache_values:
        # ---- compute pass: every local block's values ONCE ------------ #
        t0 = time.time()
        cached = {g: torch.empty((nb_local, n_ch, n_cells),
                                 dtype=torch.float32, device=local_devs[g])
                  for g in local}
        sus = {g: torch.zeros((nb_local,), dtype=torch.int32,
                              device=local_devs[g]) for g in local}
        for i in range(nb_local):
            for g in local:
                vals, nsus = block_values(g, i)
                cached[g][i] = vals
                if nsus is not None:
                    sus[g][i] = nsus
        sus_np = suspects(sus)
        stats["suspect_cells"] = int(sus_np.sum())
        if stage_times is not None:
            stage_times["compute_s"] = round(time.time() - t0, 2)

        # ---- escalate offending blocks (single process) -------------- #
        offenders = [int(q) for q in np.nonzero(sus_np)[0]]
        corr = None
        corr_qs = []
        if offenders and certify:
            if single_controller and method == "nn":
                margin_max = (n_total - n_grid) // 2
                fixed = []
                for q in offenders:
                    v_esc, left = run_streamed._escalate_block(
                        particles, q, m, n_grid, margin_cells, margin_max,
                        cell_total, quantity, exact,
                        device=local_devs[q // nb_local])
                    stats["escalated_blocks"] += 1
                    stats["uncertified_cells"] += left
                    fixed.append(v_esc.to(dev0))
                corr = torch.stack(fixed).reshape(len(fixed), -1)
                corr_qs = offenders
            else:
                warnings.warn(
                    f"{int(sus_np.sum())} cells in {len(offenders)} "
                    f"blocks could not be margin-certified "
                    f"(margin_cells={margin_cells}); escalation needs "
                    f"single-process NN — rerun with a larger "
                    f"margin_cells or on one process.",
                    stacklevel=2,
                )

        # ---- per batch: local matmul + one reduction + finish -------- #
        t0 = time.time()
        for b0 in range(0, len(betas_np), beta_batch):
            batch = betas_np[b0:b0 + beta_batch]
            B = len(batch)
            parts = []
            for g in local:
                # an escalated block's cache column is replaced
                s_re, s_im = phases(batch, g, corr_qs)
                v = cached[g].reshape(nb_local, -1)
                parts.append(torch.stack([s_re @ v, s_im @ v]))
            acc = _combine(mesh, parts)
            if corr_qs:
                sc_re, sc_im = run_streamed._s_phases(batch, corr_qs, m,
                                                      dev0)
                acc[0].add_(sc_re @ corr)
                acc[1].add_(sc_im @ corr)
            acc = acc.reshape(2, B, n_ch, n_cells)
            spectra += run_streamed._finish_batch(
                acc[0], acc[1], batch, n_grid, n_total, box, on_spectrum)
            del acc, parts
        if stage_times is not None:
            stage_times["batches_s"] = round(time.time() - t0, 2)
            stage_times.update(stats)
        return SpectrumList(spectra)

    # ------- no-cache: compute and accumulate per batch -------------- #
    chunk = run_streamed._block_chunk(nb_local, n_ch * n_cells * 4)
    sus_total = None
    for b0 in range(0, len(betas_np), beta_batch):
        batch = betas_np[b0:b0 + beta_batch]
        B = len(batch)
        s_local = {g: phases(batch, g) for g in local}
        accs = {g: torch.zeros((2, B, n_ch, n_cells), dtype=torch.float32,
                               device=local_devs[g]) for g in local}
        sus = {g: torch.zeros((nb_local,), dtype=torch.int32,
                              device=local_devs[g]) for g in local}
        for c0 in range(0, nb_local, chunk):
            c1 = min(c0 + chunk, nb_local)
            for g in local:
                vals = torch.empty((c1 - c0, n_ch, n_cells),
                                   dtype=torch.float32, device=local_devs[g])
                for i in range(c0, c1):
                    v, nsus = block_values(g, i)
                    vals[i - c0] = v
                    if nsus is not None:
                        sus[g][i] = nsus
                    del v
                s_re, s_im = s_local[g]
                run_streamed._accumulate_chunk(
                    accs[g][0], accs[g][1], vals, s_re[:, c0:c1],
                    s_im[:, c0:c1])
                del vals
        acc = _combine(mesh, [accs[g] for g in local])
        if sus_total is None:
            # blocks are recomputed identically per batch — the first
            # batch's count IS the per-sweep total
            sus_total = int(suspects(sus).sum())
        spectra += run_streamed._finish_batch(
            acc[0], acc[1], batch, n_grid, n_total, box, on_spectrum)
        del acc, accs
    stats["suspect_cells"] = sus_total or 0
    if stage_times is not None:
        stage_times.update(stats)
    if sus_total:
        warnings.warn(
            f"{sus_total} cells could not be margin-certified "
            f"(assigned neighbor at/beyond margin_cells={margin_cells}); "
            f"the uncached distributed sweep cannot escalate per block "
            f"— rerun with cache_values=True, a larger margin_cells, or "
            f"the single-card certified streamed_folded_sweep.",
            stacklevel=2,
        )
    return SpectrumList(spectra)
