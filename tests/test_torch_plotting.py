"""The plotting layer (``vpower_tpu_torch/utils/plotting.py``, the peek
and plot methods) against the JAX package's: the smoke pattern of the
JAX ``test_plotting_smoke`` (``tests/test_extras.py``), and parity: on
one numpy-seeded field and spectrum, the arrays each package hands to
``pcolormesh`` and ``loglog`` are equal.  Importing the port and its
``utils`` does not import matplotlib (the card's host has none)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


def _fields(seed=0):
    """``(port BoxField on the CPU, JAX BoxField)`` of one numpy draw;
    some cells empty, so the density's log norm sees zeros."""
    import jax.numpy as jnp
    from vpower_tpu.core.field import BoxField as JBoxField
    from vpower_tpu_torch.core.field import BoxField

    rng = np.random.default_rng(seed)
    vel = rng.standard_normal((3, N, N, N)).astype(np.float32)
    mass = (rng.random((N, N, N)) * 4.0).astype(np.float32)
    mass[rng.random((N, N, N)) < 0.2] = 0.0
    cell = 0.5 / N
    return (BoxField(velocity=torch.from_numpy(vel),
                     mass=torch.from_numpy(mass), cell_size=cell),
            JBoxField(velocity=jnp.asarray(vel), mass=jnp.asarray(mass),
                      cell_size=cell))


def _spectra(seed=1):
    """``(port, JAX)`` PowerSpectrum of the same binned arrays, two bins
    of zero power."""
    from vpower_tpu.spectrum.spectrum import PowerSpectrum as JSpectrum
    from vpower_tpu_torch.spectrum.spectrum import PowerSpectrum

    rng = np.random.default_rng(seed)
    k = 2 * np.pi * np.arange(1, 13, dtype=np.float64)
    psum = rng.random(12) * k**-1.5
    psum[[3, 7]] = 0.0
    nsample = rng.integers(1, 50, 12).astype(np.float64)
    return (PowerSpectrum.from_binned(k, psum, nsample),
            JSpectrum.from_binned(k, psum, nsample))


def test_plotting_smoke(tmp_path):
    """The JAX smoke pattern on the port: a CIC field and its spectrum,
    the module functions and the object-level delegators."""
    from vpower_tpu_torch.io.synthetic import synthetic_particles
    from vpower_tpu_torch.run.pipeline import deposit, spectrum_from_field
    from vpower_tpu_torch.utils import peek_field, peek_spectrum

    p = synthetic_particles(torch.Generator().manual_seed(6), 8,
                            jitter=0.2, device="cpu")
    field = deposit(p, 8, method="cic")
    peek_field(field, save_to=str(tmp_path / "field.png"))
    s = spectrum_from_field(field)
    peek_spectrum(s, save_to=str(tmp_path / "spec.png"))
    assert (tmp_path / "field.png").exists()
    assert (tmp_path / "spec.png").exists()
    s.peek(save_to=str(tmp_path / "peek2.png"))
    field.peek(save_to=str(tmp_path / "peek3.png"))
    ax = s.plot()
    assert len(ax.lines) == 1
    assert (tmp_path / "peek2.png").exists()
    assert (tmp_path / "peek3.png").exists()
    plt.close("all")


@pytest.mark.parametrize("index, axis", [(None, 2), (3, 0), (5, 1)])
def test_density_and_velocity_slices_match_jax(index, axis):
    """``plot_density_slice`` (300x nH-cgs, ``LogNorm(0.1, 1e3)``) and
    ``plot_velocity_slice`` of each component: the arrays, the norm and
    the mesh coordinates equal to the JAX package's."""
    from vpower_tpu.utils import plotting as jplot
    from vpower_tpu_torch.utils import plotting as tplot

    tf, jf = _fields()
    axes = plt.subplots(2, 4)[1]
    got = tplot.plot_density_slice(tf, index=index, axis=axis, ax=axes[0, 0])
    ref = jplot.plot_density_slice(jf, index=index, axis=axis, ax=axes[1, 0])
    ca, cb = got.collections[0], ref.collections[0]
    np.testing.assert_array_equal(ca.get_array(), cb.get_array())
    np.testing.assert_array_equal(ca.get_coordinates(), cb.get_coordinates())
    assert (ca.norm.vmin, ca.norm.vmax) == (cb.norm.vmin, cb.norm.vmax) \
        == (0.1, 1e3)
    for c in range(3):
        got = tplot.plot_velocity_slice(tf, c, index=index, axis=axis,
                                        ax=axes[0, c + 1])
        ref = jplot.plot_velocity_slice(jf, c, index=index, axis=axis,
                                        ax=axes[1, c + 1])
        np.testing.assert_array_equal(got.collections[0].get_array(),
                                      ref.collections[0].get_array())
        assert got.get_xlabel() == ref.get_xlabel()
    plt.close("all")


@pytest.mark.parametrize("remove_zero_power", [True, False])
def test_plot_spectrum_matches_jax(remove_zero_power):
    """``plot_spectrum``'s line (zero-power bins dropped or kept) and
    ``peek_spectrum``'s fitted-slope title equal to the JAX package's."""
    from vpower_tpu.utils import plotting as jplot
    from vpower_tpu_torch.utils import plotting as tplot

    ts, js = _spectra()
    got = tplot.plot_spectrum(ts, remove_zero_power=remove_zero_power)
    ref = jplot.plot_spectrum(js, remove_zero_power=remove_zero_power)
    xy = got.lines[0].get_xydata()
    np.testing.assert_array_equal(xy, ref.lines[0].get_xydata())
    assert len(xy) == (10 if remove_zero_power else 12)
    assert got.get_ylabel() == ref.get_ylabel()
    plt.close("all")


def test_peek_spectrum_title_matches_jax(tmp_path):
    from vpower_tpu.utils import plotting as jplot
    from vpower_tpu_torch.utils import plotting as tplot

    ts, js = _spectra(2)
    got = tplot.peek_spectrum(ts, save_to=str(tmp_path / "t.png"))
    ref = jplot.peek_spectrum(js, save_to=str(tmp_path / "j.png"))
    assert got.axes[0].get_title() == ref.axes[0].get_title()
    np.testing.assert_array_equal(got.axes[0].lines[0].get_xydata(),
                                  ref.axes[0].lines[0].get_xydata())
    plt.close("all")


def test_import_leaves_matplotlib_out():
    """``import vpower_tpu_torch, vpower_tpu_torch.utils`` and resolving
    the five plotting names import no matplotlib."""
    code = ("import sys, vpower_tpu_torch, vpower_tpu_torch.utils as u\n"
            "[getattr(u, n) for n in ('plot_density_slice', "
            "'plot_velocity_slice', 'peek_field', 'plot_spectrum', "
            "'peek_spectrum')]\n"
            "from vpower_tpu_torch.core.field import BoxField\n"
            "from vpower_tpu_torch.spectrum.spectrum import PowerSpectrum\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'jax', 'vpower_tpu')]\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
