"""The margin certificate of the PyTorch streamed sweep against the JAX
package and against brute force, on the CPU (the kernels' plain
versions).

A block's candidates are the particles within ``margin_cells`` of it, so
a cell whose true nearest neighbour lies beyond the margin would get its
nearest in-margin particle instead.  The certificate proves per cell
that the margin did not matter (assigned distance < margin); blocks it
cannot clear re-run at doubled margins, and past the periodic
representability cap a brute-force periodic search assigns the rest.
The patterns follow ``tests/test_certify.py``.

Tolerances: suspect counts, escalation counts and backstop values
bitwise; whole sweeps Nsample equal and Psum within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.run import streamed as js
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.run import streamed as ts

torch.set_num_threads(1)

PSUM_RTOL = 1e-5


def _cluster(n, hi, seed, box=1.0):
    """n particles uniform in [0, hi)^3: a void of width (box - hi) along
    every axis (the port's and the JAX package's particles)."""
    rng = np.random.default_rng(seed)
    arrs = dict(pos=rng.uniform(0.0, hi, size=(n, 3)).astype(np.float32),
                vel=rng.normal(size=(n, 3)).astype(np.float32),
                mass=np.ones(n, np.float32), density=np.ones(n, np.float32))
    return (Particles.from_numpy(box_size=box, device="cpu", **arrs),
            JParticles(box_size=box, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


def _same_sweep(got, ref):
    for a, b in zip(got, ref):
        assert a.beta == b.beta
        np.testing.assert_array_equal(a.Nsample, b.Nsample)
        np.testing.assert_allclose(a.Psum, b.Psum, rtol=PSUM_RTOL,
                                   atol=PSUM_RTOL
                                   * float(np.abs(b.Psum).max()))


def test_certificate_count_matches_bruteforce():
    """The window path's suspect count equals the brute-force count of
    interior cells whose nearest CANDIDATE reaches the margin, and the
    JAX package's count."""
    tp, jp = _cluster(40, 0.55, seed=3)
    m, n_grid, mc = 2, 32, 16  # n_ext = 64: the window route
    rows, starts, counts, pad, _, _ = ts._block_candidates(tp, m, n_grid, mc)
    n_ext = n_grid + 2 * mc
    cell = 1.0 / (m * n_grid)
    q = m**3 - 1  # the [0.5, 1)^3 block: deep-void cells
    cand = rows[starts[q]:starts[q] + pad]
    args = (n_grid, n_ext, mc, n_ext * cell, cell, "velocity")
    _, nsus = ts._nn_block_values_exact(torch.from_numpy(cand),
                                        int(counts[q]), *args, certify=True)
    _, nsus_j = js._nn_block_values_exact(jnp.asarray(cand),
                                          jnp.int32(counts[q]), *args,
                                          certify=True)
    ax = (np.arange(n_grid) + mc + 0.5) * cell
    centres = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)
    cpos = cand[:counts[q], :3].astype(np.float64)
    d2min = np.min(((centres[:, None, :] - cpos[None]) ** 2).sum(-1), axis=1)
    want = int((d2min >= (mc * cell) ** 2).sum())
    assert want > 0  # the configuration does reach the margin
    assert int(nsus) == int(nsus_j) == want


def test_single_block_rows_match_block_candidates():
    """The escalation path's one-block selection gives the same row set as
    the sorted runs at the same margin."""
    tp, _ = _cluster(150, 0.9, seed=7)
    m, n_grid, mc = 2, 16, 6
    rows, starts, counts, pad, _, mp = ts._block_candidates(tp, m, n_grid, mc)
    for q in (0, 3, 7):
        q3 = np.array([q // (m * m), (q // m) % m, q % m], np.int64)
        got, k = ts._single_block_rows(tp, q3, m, mp)
        got = got.numpy()[:k]
        want = rows[starts[q]:starts[q] + counts[q]]
        assert k == counts[q]
        ka = got[np.lexsort(np.round(got, 5).T[::-1])]
        kb = want[np.lexsort(np.round(want, 5).T[::-1])]
        np.testing.assert_allclose(ka, kb, atol=1e-5)


@pytest.mark.parametrize("exact", [False, True])
def test_certified_sweep_escalates_like_jax(exact):
    """A clustered box whose void exceeds the base margin: void blocks
    escalate (the exact ones onto window sizes), everything ends
    certified, with the JAX package's counts and spectra."""
    tp, jp = _cluster(400, 0.8, seed=11)
    kw = dict(quantity="velocity", method="nn", margin_cells=4,
              certify=True, beta_batch=8, exact=exact,
              beta_sequence=np.array([[0, 0, 0], [1, 1, 1]]))
    st, st_j = {}, {}
    got = ts.streamed_folded_sweep(tp, 16, 2, stage_times=st, **kw)
    ref = js.streamed_folded_sweep(jp, 16, 2, stage_times=st_j, **kw)
    assert st["escalated_blocks"] > 0 and st["suspect_cells"] > 0
    assert st["uncertified_cells"] == 0
    for key in ("suspect_cells", "escalated_blocks", "uncertified_cells"):
        assert st[key] == st_j[key]
    _same_sweep(got, ref)


def test_certificate_warns_on_unrepresentable_void(monkeypatch):
    """A void wider than the largest representable margin goes to the
    wrap-exact backstop; with its work budget at zero the sweep warns
    and reports the residual cells."""
    monkeypatch.setattr(ts, "_WRAP_BRUTE_BUDGET", 0.0)
    tp, _ = _cluster(60, 0.3, seed=5)
    st = {}
    with pytest.warns(UserWarning, match="uncertified"):
        ts.streamed_folded_sweep(tp, 16, 2, quantity="velocity", method="nn",
                                 margin_cells=4, certify=True, beta_batch=4,
                                 beta_sequence=np.array([[0, 0, 0]]),
                                 stage_times=st)
    assert st["uncertified_cells"] > 0


def test_wrap_exact_backstop_matches_bruteforce_and_jax():
    """Past the cap the backstop assigns the TRUE periodic NN: every
    block of a void-heavy box escalated, against a float64 host brute
    force in the wrap metric (bitwise values) and the JAX package's
    escalation."""
    tp, jp = _cluster(60, 0.3, seed=5)
    n_grid, m = 16, 2
    n_total = m * n_grid
    cell_total = 1.0 / n_total
    margin_max = (n_total - n_grid) // 2
    pos = tp.pos.double().numpy()
    vel = tp.vel.numpy()
    axc = (np.arange(n_grid) + 0.5) * cell_total
    for q in range(m**3):
        vals, left = ts._escalate_block(tp, q, m, n_grid, 4, margin_max,
                                        cell_total, "velocity", False)
        vals_j, left_j = js._escalate_block(jp, q, m, n_grid, 4, margin_max,
                                            cell_total, "velocity", False)
        assert left == left_j == 0
        q3 = np.array([q // (m * m), (q // m) % m, q % m])
        c = np.stack(np.meshgrid(*(axc + q3[a] * n_grid * cell_total
                                   for a in range(3)), indexing="ij"),
                     axis=-1).reshape(-1, 3)
        d = np.abs(c[:, None, :] - pos[None, :, :])
        d = np.minimum(d, 1.0 - d)
        ref = vel[np.argmin((d * d).sum(-1), axis=1)].T
        np.testing.assert_array_equal(vals.numpy(), ref)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))


def test_wrap_nn_brute_matches_jax():
    rng = np.random.default_rng(9)
    pos = rng.random((300, 3)).astype(np.float32)
    pay = rng.standard_normal((300, 2)).astype(np.float32)
    centres = rng.random((128, 3)).astype(np.float32)
    got = ts._wrap_nn_brute(torch.from_numpy(centres), torch.from_numpy(pos),
                            torch.from_numpy(pay), 1.0)
    ref = js._wrap_nn_brute(jnp.asarray(centres).reshape(2, 64, 3),
                            jnp.asarray(pos), jnp.asarray(pay), 1.0)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).reshape(-1, 2))


def test_certificate_quiet_on_dense_box():
    """Dense near-uniform particles: the density-aware default margin
    certifies every block, no escalation, as in the JAX package."""
    rng = np.random.default_rng(2)
    g = (np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5 + 0.3 * rng.uniform(-1, 1, (16**3, 3))) / 16
    n = g.shape[0]
    arrs = dict(pos=(g % 1.0).astype(np.float32),
                vel=rng.normal(size=(n, 3)).astype(np.float32),
                mass=np.ones(n, np.float32), density=np.ones(n, np.float32))
    tp = Particles.from_numpy(box_size=1.0, device="cpu", **arrs)
    st = {}
    sweep = ts.streamed_folded_sweep(tp, 8, 2, quantity="velocity",
                                     method="nn", beta_batch=8,
                                     stage_times=st)
    assert st["escalated_blocks"] == 0 and st["suspect_cells"] == 0
    assert len(sweep) == 8
