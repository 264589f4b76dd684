"""The block-parallel streamed sweep over a mesh of CPU entries, against the
JAX package on its 8 virtual CPU devices, on the same numpy-seeded
particles: ``distributed_streamed_sweep`` (ngp and nn, the candidate
shards, exact round-robin, the value cache with escalation),
``streamed_folded_sweep(devices=...)``, and two processes joined by
``multihost.initialize`` over ``gloo``.

Tolerances: Nsample bitwise everywhere; Psum within 2e-4 of the JAX
package's mesh (the JAX tests' own tolerance for a mesh against one
chip), within 1e-5 of the port's own single-device sweep (float32
accumulation in another order), within 1e-6 between two processes and
the in-process mesh of as many entries.

Run as a script, this file is the worker of the two-process test:
``python tests/test_torch_distributed_streamed.py RANK WORLD PORT OUT``.
The worker imports torch and the port only, so this module imports JAX
inside its tests, never at its top.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the worker, run as a script
    sys.path.insert(0, REPO)

from vpower_tpu_torch.core.particles import Particles  # noqa: E402
from vpower_tpu_torch.parallel import (  # noqa: E402
    distributed_streamed_sweep, make_mesh, multihost)
from vpower_tpu_torch.parallel import streamed as tpar  # noqa: E402
from vpower_tpu_torch.run import streamed as ts  # noqa: E402

JAX_RTOL = 2e-4
OWN_RTOL = 1e-5
PROC_RTOL = 1e-6
CPU = torch.device("cpu")

torch.set_num_threads(1)


def _arrays(n, seed, void=0.0):
    """Uniform particles in the unit box, those within ``void`` of its
    centre removed."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    pos = pos[((pos - 0.5) ** 2).sum(axis=1) > void**2]
    n = len(pos)
    return dict(pos=pos, mass=np.ones(n, np.float32),
                density=np.ones(n, np.float32),
                vel=rng.standard_normal((n, 3)).astype(np.float32))


def _particles(n, seed, void=0.0):
    """``(port particles on the CPU, JAX particles)`` of one numpy draw."""
    import jax.numpy as jnp
    from vpower_tpu import Particles as JParticles

    arrs = _arrays(n, seed, void)
    return (Particles.from_numpy(box_size=1.0, device="cpu", **arrs),
            JParticles(box_size=1.0,
                       **{k: jnp.asarray(v) for k, v in arrs.items()}))


def _same(got, ref, rtol):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert tuple(a.beta) == tuple(b.beta)
        np.testing.assert_array_equal(a.Nsample, np.asarray(b.Nsample))
        np.testing.assert_allclose(a.Psum, np.asarray(b.Psum), rtol=rtol,
                                   atol=rtol * float(np.abs(b.Psum).max()))


def _mesh(n):
    return make_mesh(n, devices=[CPU] * n)


@pytest.mark.parametrize("method", ["ngp", "nn"])
def test_distributed_streamed_sweep_matches_single_chip(method):
    """Over 8 entries: the JAX mesh's spectra and the port's own
    single-device sweep (the cache on by the auto rule, and off)."""
    import jax
    from vpower_tpu.parallel import distributed_streamed_sweep as jdss
    from vpower_tpu.parallel import make_mesh as jmake_mesh

    tp, jp = _particles(3000, 7)
    kw = dict(quantity="velocity", method=method, beta_batch=8,
              margin_cells=2)
    got = distributed_streamed_sweep(tp, 8, 2, _mesh(8), **kw)
    ref = jdss(jp, 8, 2, jmake_mesh(8, devices=jax.devices()[:8]), **kw)
    assert len(got) == 8
    _same(got, ref, JAX_RTOL)
    own = ts.streamed_folded_sweep(tp, 8, 2, **kw)
    _same(got, own, OWN_RTOL)
    uncached = distributed_streamed_sweep(tp, 8, 2, _mesh(8),
                                          cache_values=False, **kw)
    _same(uncached, own, OWN_RTOL)


def test_streamed_sweep_candidate_sharding_memory():
    """NN candidate rows are partitioned by block owner: each entry's
    shard is well under the whole candidate array (the same size the JAX
    package computes), and holds exactly its blocks' runs."""
    from vpower_tpu.run import streamed as js

    tp, jp = _particles(20000, 11)
    m, n_grid, margin, ndev = 2, 16, 4, 8
    rows, starts, counts, pad, _, _ = ts._block_candidates_device(
        tp, m, n_grid, margin)
    nb_local = m**3 // ndev
    shards, starts_dev, counts_dev, r_dev = tpar._shard_candidates(
        rows, starts, counts, pad, ndev, nb_local,
        {g: CPU for g in range(ndev)})
    assert r_dev < 0.3 * len(rows), (r_dev, len(rows))
    _, _, jcounts, jpad, _, _ = js._block_candidates(jp, m, n_grid, margin)
    assert r_dev == int(np.asarray(jcounts).reshape(ndev, nb_local)
                        .sum(axis=1).max()) + jpad
    for g in range(ndev):
        assert shards[g].shape == (r_dev, 7)
        end = 0
        for i in range(nb_local):
            q = g * nb_local + i
            s0, c = int(starts_dev[g, i]), int(counts_dev[g, i])
            assert c == counts[q]
            assert torch.equal(shards[g][s0:s0 + c],
                               rows[starts[q]:starts[q] + c])
            end = max(end, s0 + c)
        assert not shards[g][end:].any()


def test_distributed_exact_roundrobin_matches_global_exact():
    """``exact=True`` routes blocks round-robin over the entries
    (window-exact, certified, escalating); the full sweep reconstructs
    the unfolded spectrum of the JAX package's global exact deposit.
    3 entries do not divide the 8 blocks: round-robin needs no
    divisibility."""
    from vpower_tpu.deposit.nn import nn_interp_to_field
    from vpower_tpu.run.pipeline import spectrum_from_field

    tp, jp = _particles(2000, 17)
    n_grid, m = 32, 2
    s_direct = spectrum_from_field(nn_interp_to_field(jp, n_grid * m,
                                                      exact=True),
                                   quantity="velocity")
    st = {}
    combined = distributed_streamed_sweep(
        tp, n_grid, m, make_mesh(3, shape=(3, 1), devices=[CPU] * 3),
        quantity="velocity", method="nn", beta_batch=8, margin_cells=16,
        exact=True, stage_times=st,
    ).combine_all()
    assert st["uncertified_cells"] == 0
    k = min(len(combined), len(s_direct))
    np.testing.assert_array_equal(combined.Nsample[:k],
                                  np.asarray(s_direct.Nsample)[:k])
    np.testing.assert_allclose(combined.Psum[:k],
                               np.asarray(s_direct.Psum)[:k],
                               rtol=JAX_RTOL, atol=1e-30)


def test_distributed_streamed_cache_and_escalation_on_mesh():
    """The value cache: per-block suspect counts survive the mesh, the
    blocks around a void escalate as on one device and as the JAX mesh
    does, and the spectra match both.  (The JAX test's 200 particles
    escalate all 64 blocks, ~6 min for the three runs on one core; the
    void escalates 8.)"""
    import jax
    from vpower_tpu.parallel import distributed_streamed_sweep as jdss
    from vpower_tpu.parallel import make_mesh as jmake_mesh

    tp, jp = _particles(3000, 11, void=0.2)
    betas = np.array([[0, 0, 0], [1, 2, 3], [3, 1, 0]])
    kw = dict(quantity="velocity", method="nn", margin_cells=4,
              beta_sequence=betas, beta_batch=2)
    st_mesh, st_jax, st_one = {}, {}, {}
    got = distributed_streamed_sweep(tp, 8, 4, _mesh(8), cache_values=True,
                                     stage_times=st_mesh, **kw)
    assert st_mesh["escalated_blocks"] > 0
    assert st_mesh["suspect_cells"] > 0
    assert st_mesh["uncertified_cells"] == 0
    assert {"compute_s", "batches_s"} <= set(st_mesh)
    ref = jdss(jp, 8, 4, jmake_mesh(8, devices=jax.devices()[:8]),
               cache_values=True, stage_times=st_jax, **kw)
    for key in ("escalated_blocks", "suspect_cells", "uncertified_cells"):
        assert st_mesh[key] == st_jax[key], key
    _same(got, ref, JAX_RTOL)
    own = ts.streamed_folded_sweep(tp, 8, 4, stage_times=st_one, **kw)
    assert st_one["escalated_blocks"] == st_mesh["escalated_blocks"]
    assert st_one["suspect_cells"] == st_mesh["suspect_cells"]
    _same(got, own, OWN_RTOL)
    # without the cache the mesh only counts and warns, as the JAX one
    st_warn = {}
    with pytest.warns(UserWarning, match="cannot escalate per block"):
        distributed_streamed_sweep(tp, 8, 4, _mesh(8), cache_values=False,
                                   stage_times=st_warn, **kw)
    assert st_warn["suspect_cells"] == st_mesh["suspect_cells"]
    assert st_warn["escalated_blocks"] == 0


@pytest.mark.parametrize("exact", [False, True])
def test_streamed_devices_round_robin_matches_jax(exact):
    """``streamed_folded_sweep(devices=[cpu] * 3)`` against the JAX
    ``devices=`` run over 3 virtual devices (fast and exact, certified,
    with a void that escalates), and the same certificate counts."""
    import jax
    from vpower_tpu.run import streamed as js

    tp, jp = _particles(3000, 11, void=0.3)
    kw = dict(quantity="velocity", method="nn", margin_cells=4,
              beta_sequence=np.array([[0, 0, 0], [1, 0, 1], [0, 1, 1]]),
              beta_batch=2, exact=exact)
    st, st_jax = {}, {}
    got = ts.streamed_folded_sweep(tp, 8, 2, devices=[CPU] * 3,
                                   stage_times=st, **kw)
    ref = js.streamed_folded_sweep(jp, 8, 2, devices=jax.devices()[:3],
                                   stage_times=st_jax, **kw)
    assert st["escalated_blocks"] > 0
    for key in ("escalated_blocks", "suspect_cells", "uncertified_cells"):
        assert st[key] == st_jax[key], key
    _same(got, ref, OWN_RTOL)


def test_distributed_rejects_undivided_blocks_and_unknown_method():
    tp, _ = _particles(100, 3)
    with pytest.raises(ValueError, match="must divide over 3 devices"):
        distributed_streamed_sweep(tp, 8, 2, make_mesh(
            3, shape=(3, 1), devices=[CPU] * 3), method="ngp")
    with pytest.raises(ValueError, match="Unsupported method"):
        distributed_streamed_sweep(tp, 8, 2, _mesh(2), method="tsc")


# ---------------------------------------------------------------------- #
# two processes over gloo                                                 #
# ---------------------------------------------------------------------- #
# the runs of each process, and of the in-process mesh of as many entries
RUNS = {
    "ngp": dict(method="ngp"),
    "ngp_uncached": dict(method="ngp", cache_values=False),
    "nn": dict(method="nn", margin_cells=2),
}
# on a mesh of two processes only: exact NN takes the ring-refined path
EXACT = dict(method="nn", margin_cells=2, exact=True, certify=False)


def _run_all(mesh, runs):
    tp = Particles.from_numpy(box_size=1.0, device="cpu", **_arrays(1500, 8))
    out = {}
    for name, kw in runs.items():
        sweep = distributed_streamed_sweep(tp, 8, 2, mesh,
                                           quantity="velocity",
                                           beta_batch=4, **kw)
        out[name + "_Psum"] = np.stack([s.Psum for s in sweep])
        out[name + "_Nsample"] = np.stack([s.Nsample for s in sweep])
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_in_process_mesh(tmp_path):
    """Two processes meet through ``multihost.initialize(...,
    device="cpu")``, lay ``global_mesh`` over their entries and run the
    sweeps: their spectra equal the in-process two-entry mesh's, and
    exact NN there runs the ring-refined path with the JAX package's
    warning."""
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    env = {**os.environ, "PYTHONPATH": REPO}
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    workers = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in range(2)]
    logs = []
    try:
        for w in workers:
            logs.append(w.communicate(timeout=240)[0].decode())
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
    for r, (w, log) in enumerate(zip(workers, logs)):
        assert w.returncode == 0, f"worker {r} failed:\n{log}"
        assert f"worker {r} OK" in log, log

    ref = _run_all(_mesh(2), RUNS)
    for r in range(2):
        got = np.load(outs[r])
        assert bool(got["warned"]), "no multi-host exact warning"
        np.testing.assert_array_equal(got["exact_Nsample"],
                                      ref["nn_Nsample"])
        assert np.isfinite(got["exact_Psum"]).all()
        assert (got["exact_Psum"] > 0).any()
        for name in RUNS:
            np.testing.assert_array_equal(got[name + "_Nsample"],
                                          ref[name + "_Nsample"])
            np.testing.assert_allclose(
                got[name + "_Psum"], ref[name + "_Psum"], rtol=PROC_RTOL,
                atol=PROC_RTOL * float(np.abs(ref[name + "_Psum"]).max()))


def test_single_process_initialize_is_a_noop():
    multihost.initialize(device="cpu")
    assert not multihost.is_multiprocess()
    assert not torch.distributed.is_initialized()


def _worker(rank, world, port, out):
    import warnings

    multihost.initialize(f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, device="cpu")
    try:
        assert multihost.is_multiprocess()
        mesh = multihost.global_mesh(device="cpu")
        assert mesh.devices.shape == (world, 1)
        assert mesh.process_index == rank
        res = _run_all(mesh, RUNS)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res.update(_run_all(mesh, {"exact": EXACT}))
        res["warned"] = any("multi-host mesh" in str(w.message)
                            for w in rec)
        np.savez(out, **res)
    finally:
        torch.distributed.destroy_process_group()
    print(f"worker {rank} OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
