"""PyTorch port: containers, synthetic workload and package boundary.

The synthetic generators cannot reproduce ``jax.random``'s numbers, so
the Gaussian random field is held to the same k-space filter written
out in numpy and applied to the same noise (drawn again from an
identically seeded generator); everything deterministic given its
inputs is held to the JAX package exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.io import synthetic as jsyn
from vpower_tpu_torch.core.field import BoxField
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.io import synthetic as tsyn
from vpower_tpu_torch.spectrum import fold as tfold
from vpower_tpu_torch.spectrum import power as tpower

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(n_p, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n_p, 3), np.float32),
            (rng.random(n_p) + 0.5).astype(np.float32),
            (rng.random(n_p) + 0.5).astype(np.float32),
            rng.standard_normal((n_p, 3)).astype(np.float32))


def test_particles_from_numpy_matches_jax():
    pos, mass, rho, vel = _arrays(500, 1)
    p = Particles.from_numpy(pos, mass, rho, vel, 2.0, device="cpu")
    pj = JParticles(pos=jnp.asarray(pos), mass=jnp.asarray(mass),
                    density=jnp.asarray(rho), vel=jnp.asarray(vel),
                    box_size=2.0)
    assert len(p) == len(pj) == 500
    assert p.box_size == 2.0 and p.dtype == torch.float32
    np.testing.assert_array_equal(p.density_velocity_vector().numpy(),
                                  np.asarray(pj.density_velocity_vector()))
    q = p.to("cpu")
    assert torch.equal(q.pos, p.pos) and q.box_size == p.box_size
    pos[0, 0] = 7.0  # from_numpy copies
    assert p.pos[0, 0] != 7.0


def test_boxfield_from_numpy():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    m = rng.random((8, 8, 8)).astype(np.float32)
    f = BoxField.from_numpy(v, m, 0.25, device="cpu")
    assert f.n_grid == 8 and f.box_size == 2.0
    np.testing.assert_array_equal(f.velocity.numpy(), v)
    with pytest.raises(ValueError, match="channels-first"):
        BoxField(velocity=torch.zeros(8, 8, 8, 3), mass=torch.zeros(8, 8, 8),
                 cell_size=1.0)


def _numpy_grf(noise, box, spectral_index):
    """The filter of vpower_tpu/io/synthetic.py:53-64 in numpy, float32."""
    n = noise.shape[-1]
    idx = np.arange(n)
    wrapped = np.where(idx < (n + 1) // 2, idx, idx - n)
    ks = (np.float32(2.0 * np.pi / box) * wrapped.astype(np.float32))
    kmag = np.sqrt(ks[:, None, None] ** 2 + ks[None, :, None] ** 2
                   + ks[None, None, :] ** 2)
    safe = np.where(kmag > 0, kmag, np.float32(2.0 * np.pi / box))
    filt = np.where(kmag > 0, np.sqrt(safe ** np.float32(spectral_index)), 0.0)
    return np.stack([np.real(np.fft.ifftn(np.fft.fftn(c) * filt))
                     for c in noise])


def test_gaussian_random_field_filter():
    """Same noise, same filter: agreement to float32 FFT rounding (the
    numpy mirror runs in float64), rtol 1e-5 of the field's scale."""
    n, box, idx = 16, 2.0, -11.0 / 3.0
    got = tsyn.gaussian_random_field(torch.Generator().manual_seed(3), n, box,
                                     spectral_index=idx).numpy()
    g = torch.Generator().manual_seed(3)
    noise = np.stack([torch.randn((n,) * 3, generator=g).numpy()
                      for _ in range(3)])
    ref = _numpy_grf(noise, box, idx)
    assert got.shape == (3, n, n, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    # the radial filter leaves the field real with zero mean
    assert abs(float(got.mean())) < 1e-6 * float(np.abs(got).max())


def test_grid_positions_and_sampling_match_jax():
    n, box = 12, 3.0
    lat = tsyn.grid_positions(n, box, device="cpu").numpy()
    np.testing.assert_array_equal(lat, np.asarray(jsyn.grid_positions(n, box)))
    jit = tsyn.grid_positions(n, box, generator=torch.Generator().manual_seed(4),
                              jitter=3.0).numpy()
    assert jit.shape == (n**3, 3)
    assert (jit >= 0).all() and (jit <= box).all()
    assert np.abs(jit - lat).max() > 0.1 * box / n
    field = np.random.default_rng(5).standard_normal((3, 8, 8, 8)) \
        .astype(np.float32)
    p = tsyn.particles_from_field(torch.from_numpy(field), box,
                                  torch.from_numpy(jit))
    pj = jsyn.particles_from_field(jnp.asarray(field), box, jnp.asarray(jit))
    for name in ("pos", "vel", "mass", "density"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(pj, name)))


def test_synthetic_particles_shapes():
    p = tsyn.synthetic_particles(torch.Generator().manual_seed(6), 8,
                                 jitter=0.4)
    assert len(p) == 512 and p.vel.shape == (512, 3)
    assert torch.isfinite(p.vel).all()


def test_import_does_not_import_jax():
    code = ("import sys, vpower_tpu_torch; "
            "from vpower_tpu_torch.deposit import nn_index_sweep, nn_window, "
            "sph; "
            "from vpower_tpu_torch.io import bricks, checkpoint, native, "
            "snapshot; "
            "from vpower_tpu_torch.run import cli, streamed; "
            "from vpower_tpu_torch.utils import checks, profiling; "
            "from vpower_tpu_torch import parallel; "
            "from vpower_tpu_torch.parallel import deposit, planner; "
            "from vpower_tpu_torch import fft; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'vpower_tpu' not in sys.modules, 'vpower_tpu imported'; "
            "assert 'h5py' not in sys.modules, 'h5py imported'")
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _construct(name, **kw):
    pos, mass, rho, vel = _arrays(10, 3)
    if name == "particles":
        return Particles.from_numpy(pos, mass, rho, vel, 1.0, **kw).pos
    if name == "boxfield":
        return BoxField.from_numpy(np.zeros((3, 4, 4, 4), np.float32),
                                   np.ones((4, 4, 4), np.float32), 0.25,
                                   **kw).velocity
    if name == "window_compensation":
        return tpower.window_compensation(4, 1, **kw)
    if name == "bin_grid":
        return tpower.bin_grid(4, 1.0, 2 * np.pi, 2 * np.pi, 2, **kw)
    if name == "bin_grid_local":
        return tpower.bin_grid_local((2, 4, 4), 4, 1.0, 2 * np.pi,
                                     2 * np.pi, 2, (2, 0, 0), **kw)
    if name == "hermitian_weights":
        return tpower.hermitian_weights(4, **kw)
    if name == "get_phase":
        return tfold.get_phase((1, 0, 1), 8, 4, **kw)
    return tsyn.grid_positions(4, 1.0, **kw)


@pytest.mark.parametrize("name", ["particles", "boxfield", "grid_positions",
                                  "window_compensation", "bin_grid",
                                  "bin_grid_local", "hermitian_weights",
                                  "get_phase"])
def test_constructors_default_to_the_card(name):
    """With no device, the host-array constructors and the lattices ask
    for the card: on a torch without one they raise, never land on the
    CPU; a caller who names the CPU gets CPU tensors."""
    if torch.cuda.is_available():
        assert _construct(name).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            _construct(name)
    assert _construct(name, device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """The plain versions run only because a tensor lies on the CPU: any
    other device launches the kernel or raises, never falls back."""
    from vpower_tpu_torch.deposit.nn_index_sweep import sweep_tiles
    from vpower_tpu_torch.deposit.nn_sweep import sweep_tiles_vals
    from vpower_tpu_torch.deposit.nn_window import window_pass
    from vpower_tpu_torch.deposit.sorted_scatter import deposit_sorted

    sids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        deposit_sorted(sids, torch.zeros(4, 2, device="meta"), 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sweep_tiles_vals(torch.zeros(4, 4, 4, 4, device="meta"), None, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sweep_tiles(torch.zeros(4, 4, 4, dtype=torch.int32, device="meta"),
                    torch.zeros(3, 4, 4, 4, device="meta"), None, None, 1.0)
    s = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        window_pass(s, s, torch.zeros(8, 512, device="meta"),
                    torch.zeros(1, 64, 64, 64, device="meta"), n_grid=64,
                    zc=64, n_pay=0, wrap=True)
