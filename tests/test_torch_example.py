"""The example twin (``examples/full_recipe_torch.py``) against the JAX
example's steps (``examples/full_recipe.py``) at its sizes: a 32^3 base
grid, m = 2, 24^3 particles.  The particles are the JAX example's own
draw (``synthetic_particles(PRNGKey(42), 24, jitter=0.4)``) as numpy
arrays, given to both packages.  The low-k deposit is exact NN, as both
examples' docstrings name it (the JAX example's code calls the fast
descent; the twin and the reference chain here take ``exact=True``).

Tolerances: ``k`` and Nsample bitwise; Psum within 1e-5 of the JAX
chain, the sweep's gate (``tests/test_torch_streamed.py``: float32
FFTs and sums in another order, the same NN choices)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSUM_RTOL = 1e-5


def _example():
    spec = importlib.util.spec_from_file_location(
        "full_recipe_torch", os.path.join(REPO, "examples",
                                          "full_recipe_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_recipe_matches_the_jax_steps(tmp_path):
    import jax
    from vpower_tpu import (spectrum_from_field, streamed_folded_sweep,
                            synthetic_particles)
    from vpower_tpu.deposit.nn import nn_interp_to_field
    from vpower_tpu_torch.core.particles import Particles

    ex = _example()
    jp = synthetic_particles(jax.random.PRNGKey(42), ex.N_LATTICE,
                             box_size=1.0, jitter=0.4)
    arrs = {k: np.asarray(getattr(jp, k))
            for k in ("pos", "vel", "mass", "density")}
    tp = Particles.from_numpy(box_size=1.0, device="cpu", **arrs)

    got = ex.run_recipe(tp, str(tmp_path), ex.N_GRID, ex.FOLD_M)

    low_k = spectrum_from_field(nn_interp_to_field(jp, ex.N_GRID, exact=True),
                                quantity="velocity")
    high_k = streamed_folded_sweep(jp, ex.N_GRID, ex.FOLD_M,
                                   quantity="velocity", method="nn",
                                   beta_batch=8).combine_all()
    high_k.m = ex.FOLD_M
    ref = low_k.append(high_k)
    assert len(got) == len(ref) and got.k[-1] > low_k.k[-1]
    np.testing.assert_array_equal(got.k, ref.k)
    np.testing.assert_array_equal(got.Nsample, ref.Nsample)
    np.testing.assert_allclose(got.Psum, ref.Psum, rtol=PSUM_RTOL,
                               atol=PSUM_RTOL * float(ref.Psum.max()))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "Pk.txt"),
                                  got.data())


def test_main_writes_the_snapshot_spectrum_and_plot(tmp_path):
    """``main`` on the CPU at a reduced size (the module's sizes set on
    this instance of it): the snapshot round trip, ``Pk.txt`` equal to
    ``run_recipe``'s on the loaded particles, and the plot."""
    pytest.importorskip("h5py")
    from vpower_tpu_torch import load_snapshot

    ex = _example()
    ex.N_GRID = ex.N_LATTICE = 8
    out = tmp_path / "out"
    full = ex.main([str(out), "--device", "cpu"])
    for name in ("snapshot.hdf5", "Pk.txt", "Pk.png"):
        assert (out / name).exists(), name
    p = load_snapshot(str(out / "snapshot.hdf5"), box_size=1.0,
                      device="cpu")
    assert len(p) == 8**3 and p.pos.device.type == "cpu"
    again = ex.run_recipe(p, str(tmp_path / "again"), 8, ex.FOLD_M)
    np.testing.assert_array_equal(again.data(), full.data())
    np.testing.assert_array_equal(np.loadtxt(out / "Pk.txt"), full.data())
