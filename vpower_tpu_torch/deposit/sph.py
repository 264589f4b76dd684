"""SPH (adaptive-kernel) deposition on the sorted deposit K1: the
Voxelize replacement.

PyTorch counterpart of :mod:`vpower_tpu.deposit.sph` (reference
``vpower/interp.py:280-340``).  Each particle scatters ``[m*v, m]`` into
every cell centre within its kernel support, weighted by the kernel at
that centre and normalized over the particle's sampled footprint, so
the deposited totals equal the particle totals.  The footprint is the
static offset cube ``(2 s_max + 1)^3``; h is clamped to ``s_max + 1/2``
cells (:func:`sph_deposit`) or handled on coarser grids
(:func:`sph_deposit_multires`).

One route, the JAX package's sorted, rolled formulation
(``_sph_deposit_mxu``): one stable sort by the clipped base cell, the
per-particle weight sum over the offsets, the degenerate own-cell rule,
then one K1 deposit an offset, each adding its sums in place at the
base cells shifted by the offset
(:func:`~.sorted_scatter.deposit_offsets_rolled`).  The weights are made
of ``+ - * /``, ``sqrt``, ``floor`` and ``round`` only, each its own
correctly rounded tensor operation (no fused multiply-add; the square
root through :func:`_sqrt`), so a CUDA run equals a CPU run bit for bit
given the same ``h``.

On a CUDA tensor the weights are the hand-written kernel K6
(``csrc/sph_weights.cu``, :func:`_deposit_k6`): one launch sums each
row's weights, then one launch an offset writes that offset's weighted
rows into one buffer that K1 reads.  On a CPU tensor they are the torch
code (:func:`_deposit_torch`, K6's plain version), which hands
``deposit_offsets_rolled`` a weight function; the two agree bit for bit.
Any other device raises.  ``SPH_WEIGHT_LAUNCHES`` counts K6's launches:
``norm`` (one a deposit) and ``rows`` (one an offset).

Spans (``utils/profiling.py:span``): the sort runs in
``vpower.deposit.sort``; the normalization pass, and each offset's
weights and weighted rows, in ``vpower.sph.weights``, whose first span
counts the clamped (``clamped``) and the degenerate (``degenerate``)
particles while a profiler records.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.arith import _f32, div
from ..core.field import BoxField
from ..core.particles import Particles
from ..utils.profiling import span
from .sorted_scatter import deposit_offsets_rolled, sort_rows

__all__ = [
    "sph_deposit",
    "sph_deposit_multires",
    "sph_interp_to_field",
    "kernel_weight",
    "SPH_WEIGHT_LAUNCHES",
]

# K6's launches: the normalization pass, and one an offset's rows
SPH_WEIGHT_LAUNCHES = {"norm": 0, "rows": 0}
_KERNEL_IDS = {"cubic_spline": 0, "sphere": 1}  # kSphere of the source


def kernel_weight(q: torch.Tensor, kind: str) -> torch.Tensor:
    """Unnormalized kernel value at q = r / h (support q < 1).  The
    powers are products, as XLA lowers the JAX package's ``q**2``,
    ``q**3`` (``q * (q * q)``)."""
    if kind == "cubic_spline":
        # M4 cubic spline with support radius h (Gadget convention)
        q2 = q * q
        inner = (1.0 - 6.0 * q2) + 6.0 * (q * q2)
        m = torch.clamp(1.0 - q, min=0.0)
        outer = 2.0 * (m * (m * m))
        return torch.clamp(torch.where(q < 0.5, inner, outer), min=0.0)
    if kind == "sphere":
        return (q < 1.0).to(q.dtype)
    raise ValueError(f"Unknown kernel {kind!r}")


def _sorted_rows(pos, values, h_eff, n_grid: int, cell: float):
    """One stable sort by the base cell clipped to ``[0, n - 1]``:
    ``(sids, svals, spos, sh)``, the rows contiguous and float32."""
    base = torch.clamp(torch.floor(div(pos, cell)).to(torch.int32), 0,
                       n_grid - 1)
    ids = (base[:, 0] * n_grid + base[:, 1]) * n_grid + base[:, 2]
    sids, _, svals, spos, sh = sort_rows(ids, values.to(torch.float32), pos,
                                         h_eff)
    return sids, svals, spos, sh


def _axis_sq(spos, cell: float, box_size: float, s_max: int,
             periodic: bool):
    """Per axis and offset d, the squared distance along that axis to
    the centre ``((base + d) + 0.5) * cell``, with ``base`` the
    unclipped cell of the sorted position (a centre depends on one
    axis's offset only): ``[{d: (N,)}] * 3``."""
    sbase = torch.floor(div(spos, cell)).to(torch.int32).to(spos.dtype)
    sq = []
    for a in range(3):
        per_axis = {}
        for d in range(-s_max, s_max + 1):
            delta = spos[:, a] - ((sbase[:, a] + float(d)) + 0.5) * cell
            if periodic:
                delta = delta - box_size * torch.round(div(delta, box_size))
            per_axis[d] = delta * delta
        sq.append(per_axis)
    return sq


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on the CPU and on the card: the
    float64 root rounded once to ``x``'s dtype.  PyTorch's float32
    ``sqrt`` on the CPU (SLEEF) misses by an ulp on some inputs; a
    float64 root within an ulp rounds to the exact float32 one, because
    the root of a float32 never lies that close to a float32 midpoint."""
    return torch.sqrt(x.double()).to(x.dtype)


def _offset_weight(sq, sh, d, kernel: str) -> torch.Tensor:
    """Kernel weight of every sorted row at offset ``d``; the squared
    distance summed ``(dx^2 + dy^2) + dz^2``."""
    r = _sqrt((sq[0][d[0]] + sq[1][d[1]]) + sq[2][d[2]])
    return kernel_weight(r / sh, kernel)


def _weight_sum(sq, sh, s_max: int, kernel: str) -> torch.Tensor:
    """Per-row weight sum over the offset cube, offsets in x, y, z order
    (the normalization pass)."""
    offs = range(-s_max, s_max + 1)
    wsum = torch.zeros_like(sh)
    for dx in offs:
        for dy in offs:
            for dz in offs:
                wsum = wsum + _offset_weight(sq, sh, (dx, dy, dz), kernel)
    return wsum


def _norm_weight(sq, sh, wsum, degenerate, d, kernel: str) -> torch.Tensor:
    """Normalized weight of every sorted row at offset ``d`` (K6's plain
    version of a row's weight): :func:`_offset_weight` over ``wsum`` (the
    weight sums with the degenerate rows' set to 1), then the degenerate
    rule: weight 1 at offset (0, 0, 0) where ``degenerate``, else 0."""
    w = _offset_weight(sq, sh, d, kernel) / wsum
    return torch.where(degenerate, 1.0 if d == (0, 0, 0) else 0.0, w)


def _k6(entry: str, argtypes, *args, device) -> None:
    """Launch K6's C entry ``entry`` on ``device``'s current stream."""
    from .. import _build

    fn = getattr(_build.load("sph_weights"), entry)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sph_weights kernel launch failed: "
                           f"cudaError_t {rc}")


def _k6_check(kernel: str, *expected) -> None:
    """Raise unless each ``(tensor, shape)`` is a contiguous float32
    tensor of that shape on the first one's CUDA device, and ``kernel``
    is one K6 computes."""
    dev = expected[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"K6 runs on cuda tensors, not {dev}")
    if kernel not in _KERNEL_IDS:
        raise ValueError(f"Unknown kernel {kernel!r}")
    for t, shape in expected:
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"K6 takes contiguous float32 {shape} on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def _k6_weight_sum(spos, sh, s_max: int, cell: float, box_size: float,
                   kernel: str, periodic: bool) -> torch.Tensor:
    """K6's normalization pass: each sorted row's kernel-weight sum over
    the offset cube, as :func:`_weight_sum` of :func:`_axis_sq` forms it,
    before the degenerate rule: (N,) float32."""
    n = sh.shape[0]
    _k6_check(kernel, (spos, (n, 3)), (sh, (n,)))
    wsum = torch.empty_like(sh)
    _k6("sph_weight_sum",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_int],
        spos.data_ptr(), sh.data_ptr(), wsum.data_ptr(), sh.shape[0], s_max,
        cell, box_size, int(periodic), _KERNEL_IDS[kernel],
        device=spos.device)
    SPH_WEIGHT_LAUNCHES["norm"] += 1
    return wsum


def _k6_offset_rows(spos, sh, wsum, svals, d, cell: float, box_size: float,
                    kernel: str, periodic: bool, out: torch.Tensor):
    """K6's rows of offset ``d`` written into ``out`` (N, C): ``svals``
    times each row's normalized weight at ``d``, the degenerate rule
    applied (weight 1 at (0, 0, 0) where ``wsum <= 0``, else 0)."""
    n, rows = sh.shape[0], (sh.shape[0], svals.shape[-1])
    _k6_check(kernel, (spos, (n, 3)), (sh, (n,)), (wsum, (n,)),
              (svals, rows), (out, rows))
    _k6("sph_offset_rows",
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2,
        spos.data_ptr(), sh.data_ptr(), wsum.data_ptr(), svals.data_ptr(),
        out.data_ptr(), svals.shape[0], svals.shape[1], *d, cell, box_size,
        int(periodic), _KERNEL_IDS[kernel], device=spos.device)
    SPH_WEIGHT_LAUNCHES["rows"] += 1
    return out


def _deposit_torch(sids, svals, spos, sh, n_grid, s_max, clamped, *, cell,
                   box_size, kernel, periodic):
    """The weights in torch and the offsets' deposits (the CPU route, and
    K6's plain version): the per-axis distances once, the weight sums,
    then each offset's normalized weights handed to
    ``deposit_offsets_rolled``.  ``clamped()`` gives the count of clamped
    particles for the span's counter."""
    with span("vpower.sph.weights") as rec:
        sq = _axis_sq(spos, cell, box_size, s_max, periodic)
        wsum = _weight_sum(sq, sh, s_max, kernel)
        # particles whose kernel misses every sampled centre (h much
        # smaller than a cell) deposit NGP-style into their own cell
        degenerate = wsum <= 0.0
        wsum = torch.where(degenerate, 1.0, wsum)
        if rec is not None:
            rec.count(clamped=clamped(), degenerate=degenerate.sum())

    def norm_weight(d):
        with span("vpower.sph.weights"):
            return _norm_weight(sq, sh, wsum, degenerate, d, kernel)

    return deposit_offsets_rolled(sids, svals, norm_weight,
                                  range(-s_max, s_max + 1), n_grid)


def _deposit_k6(sids, svals, spos, sh, n_grid, s_max, clamped, **geom):
    """The same on the card with K6: the weight sums in one launch, then
    one launch an offset writing its weighted rows into one (N, C) buffer
    that K1 reads before the next offset's launch (one stream)."""
    with span("vpower.sph.weights") as rec:
        wsum = _k6_weight_sum(spos, sh, s_max, **geom)
        if rec is not None:
            rec.count(clamped=clamped(), degenerate=(wsum <= 0.0).sum())
    rows = torch.empty_like(svals)

    def offset_rows(d):
        with span("vpower.sph.weights"):
            return _k6_offset_rows(spos, sh, wsum, svals, d, out=rows, **geom)

    return deposit_offsets_rolled(sids, svals, None, range(-s_max, s_max + 1),
                                  n_grid, rows_fn=offset_rows)


def sph_deposit(
    pos: torch.Tensor,
    values: torch.Tensor,
    h: torch.Tensor,
    n_grid: int,
    box_size: float,
    s_max: int = 2,
    kernel: str = "cubic_spline",
    periodic: bool = True,
) -> torch.Tensor:
    """Scatter (N, C) ``values`` with per-particle kernel radii ``h`` into
    a CHANNELS-FIRST (C, n, n, n) float32 grid.  Per-particle weights sum
    to 1 over the sampled footprint, so column sums are conserved.
    ``periodic=False`` drops the minimum image from the distances; the
    offsets' shifts still wrap, as the JAX package's rolls do."""
    route = {"cpu": _deposit_torch, "cuda": _deposit_k6}.get(pos.device.type)
    if route is None:
        raise ValueError(f"sph_deposit runs on cpu or cuda tensors, not "
                         f"{pos.device}")
    cell = box_size / n_grid
    pos = torch.remainder(pos, box_size)
    # support clamped to the static footprint (reference analog: the
    # uniform padding cap, interp.py:216-243); bounds rounded once
    h_lo, h_hi = _f32(1e-6 * cell), _f32((s_max + 0.5) * cell)
    h_eff = torch.clamp(h, min=h_lo, max=h_hi)
    with span("vpower.deposit.sort"):
        sids, svals, spos, sh = _sorted_rows(pos, values, h_eff, n_grid,
                                             cell)
    return route(sids, svals, spos, sh, n_grid, s_max,
                 lambda: ((h < h_lo) | (h > h_hi)).sum(), cell=cell,
                 box_size=box_size, kernel=kernel, periodic=periodic)


def _upsample_add(fine: torch.Tensor, coarse: torch.Tensor,
                  factor: int) -> torch.Tensor:
    """Add a (C, n/f, n/f, n/f) coarse grid into the fine grid, each
    coarse cell's content spread equally over its f^3 children."""
    c = div(coarse, float(factor**3))
    for ax in (1, 2, 3):
        c = torch.repeat_interleave(c, factor, dim=ax)
    return fine + c


def sph_deposit_multires(
    pos: torch.Tensor,
    values: torch.Tensor,
    h: torch.Tensor,
    n_grid: int,
    box_size: float,
    s_max: int = 2,
    kernel: str = "cubic_spline",
    periodic: bool = True,
    levels: int = 1,
) -> torch.Tensor:
    """Adaptive-support SPH scatter without clamping large kernels: level
    k deposits the particles whose support needs up to ``s_max * 2^k``
    fine cells onto a 2^k-times coarser grid, then refines it
    conservatively (:func:`_upsample_add`).  Kernel shapes resolve to
    ``support / s_max`` cells; totals stay conserved per particle."""
    if levels <= 1:
        return sph_deposit(pos, values, h, n_grid, box_size, s_max=s_max,
                           kernel=kernel, periodic=periodic)
    if n_grid % (2 ** (levels - 1)):
        raise ValueError("n_grid must divide by 2^(levels-1)")
    support = div(h, box_size / n_grid)  # kernel radius in fine cells
    # class k: support in (s_max * 2^(k-1), s_max * 2^k]
    klass = torch.ceil(torch.log2(torch.clamp(
        div(support, float(s_max)), min=_f32(1e-9)))).to(torch.int32)
    klass = torch.clamp(klass, 0, levels - 1)
    grid = None
    for k in range(levels):
        mask = (klass == k).to(values.dtype)
        gk = sph_deposit(pos, values * mask[:, None], h, n_grid >> k,
                         box_size, s_max=s_max, kernel=kernel,
                         periodic=periodic)
        grid = gk if k == 0 else _upsample_add(grid, gk, 1 << k)
    return grid


def sph_interp_to_field(
    particles: Particles,
    n_grid: int,
    smoothing_rate: float = 1.0,
    s_max: int = 2,
    kernel: str = "cubic_spline",
    periodic: bool = True,
    clamp_support: bool = True,
    edge_removal: float = 0.0,
) -> BoxField:
    """SPH-deposit ``[m*v, m]`` and form a BoxField (reference
    ``GasParticles.voxelize_interp_to_field``, ``interp.py:280-340``):
    smoothing length from :meth:`Particles.smoothing_length`,
    conservative spreading, then ``v = p / m`` where ``m > 0``.

    ``clamp_support=False`` takes the multi-resolution path with as many
    levels as the largest kernel needs (one host sync for ``max(h)``).
    ``edge_removal > 0`` deposits a coverage channel (ones per particle)
    and zeroes cells whose coverage falls below it (reference
    ``interp.py:310-323``)."""
    values = [particles.vel * particles.mass[:, None],
              particles.mass[:, None]]
    if edge_removal > 0:
        values.append(torch.ones((len(particles), 1), dtype=particles.dtype,
                                 device=particles.pos.device))
    values = torch.cat(values, dim=1)
    h = particles.smoothing_length(smoothing_rate)
    kw = dict(s_max=s_max, kernel=kernel, periodic=periodic)
    if clamp_support:
        grid = sph_deposit(particles.pos, values, h, n_grid,
                           particles.box_size, **kw)
    else:
        max_support = float(torch.max(h)) / (particles.box_size / n_grid)
        levels = 1
        while s_max * 2 ** (levels - 1) < max_support and \
                n_grid % (2**levels) == 0:
            levels += 1
        grid = sph_deposit_multires(particles.pos, values, h, n_grid,
                                    particles.box_size, levels=levels, **kw)
    m_grid = grid[3]
    if edge_removal > 0:
        m_grid = torch.where(grid[4] >= edge_removal, m_grid, 0.0)
    safe = torch.where(m_grid > 0, m_grid, 1.0)
    v_grid = torch.where(m_grid[None] > 0, grid[:3] / safe[None], 0.0)
    return BoxField(velocity=v_grid, mass=m_grid,
                    cell_size=particles.box_size / n_grid)
