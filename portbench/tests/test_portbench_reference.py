"""The plain references against direct NumPy chains at 16^3: NGP
momentum, CIC velocity and exact nearest-neighbour velocity, each
deposited, transformed and binned by hand here."""
import numpy as np
import pytest
import torch

from portbench.reference import common, nn_velocity, scatter
from portbench.snapshot import make_snapshot

N = 16
RECIPE = {"n_field": 16, "n_lattice": 12, "jitter": 3.0, "box_size": 1.0,
          "spectral_index": -11.0 / 3.0}


@pytest.fixture(scope="module")
def snap():
    return make_snapshot(RECIPE, 7, "cpu")


def _shells(power):
    """Full-grid float64 shells: bin i holds i + 1/2 <= |K| < i + 3/2."""
    k = np.fft.fftfreq(N, 1.0 / N)
    kk = np.sqrt(k[:, None, None]**2 + k[None, :, None]**2
                 + k[None, None, :]**2)
    nb = common.n_bins(1.0, N)
    idx = np.floor(kk - 0.5).astype(int)
    keep = (idx >= 0) & (idx < nb)
    return (np.bincount(idx[keep], power[keep], nb),
            np.bincount(idx[keep], minlength=nb))


def _power(grid):
    a = (1.0 / (2 * np.pi)) ** 1.5 / N**3
    return sum(0.5 * np.abs(a * np.fft.fftn(g)) ** 2 for g in grid)


def _arrays(snap):
    return (snap["pos"].double().numpy(), snap["vel"].double().numpy(),
            snap["mass"].double().numpy())


def _ngp(snap):
    pos, vel, mass = _arrays(snap)
    ijk = np.floor(pos * N).astype(int) % N
    flat = (ijk[:, 0] * N + ijk[:, 1]) * N + ijk[:, 2]
    return [np.bincount(flat, mass * vel[:, c], N**3).reshape((N,) * 3)
            for c in range(3)]


def _cic(snap):
    pos, vel, mass = _arrays(snap)
    u = pos * N - 0.5
    b = np.floor(u).astype(int)
    f = u - b
    g = np.zeros((4, N**3))
    for d in np.ndindex(2, 2, 2):
        w = np.prod([f[:, a] if d[a] else 1 - f[:, a] for a in range(3)], 0)
        ijk = (b + d) % N
        flat = (ijk[:, 0] * N + ijk[:, 1]) * N + ijk[:, 2]
        for c in range(4):
            g[c] += np.bincount(flat, w * (mass * vel[:, c] if c < 3
                                           else mass), N**3)
    v = np.where(g[3] > 0, g[:3] / np.where(g[3] > 0, g[3], 1.0), 0.0)
    return list(v.reshape((3,) + (N,) * 3))


def _nn(snap):
    pos, vel, _ = _arrays(snap)
    cc = (np.indices((N,) * 3).reshape(3, -1).T + 0.5) / N
    d = cc[:, None, :] - pos[None]
    d -= np.round(d)
    best = np.argmin((d**2).sum(-1), 1)
    return list(vel[best].T.reshape((3,) + (N,) * 3))


@pytest.mark.parametrize("ref, chain", [
    (scatter.ngp_momentum, _ngp),
    (scatter.cic_velocity, _cic),
    (nn_velocity.spectrum, _nn),
], ids=["ngp_momentum", "cic_velocity", "nn_velocity"])
def test_reference_matches_numpy_chain(snap, ref, chain):
    psum, nsamp = ref(snap, N)
    want_psum, want_nsamp = _shells(_power(chain(snap)))
    np.testing.assert_array_equal(nsamp, want_nsamp)
    np.testing.assert_allclose(psum, want_psum, rtol=1e-12)


def test_nn_index_is_the_brute_force_nearest(snap):
    pos = torch.remainder(snap["pos"].double(), 1.0)
    got = nn_velocity.nn_index(pos, N, 1.0, bucket=2).numpy()
    cc = (np.indices((N,) * 3).reshape(3, -1).T + 0.5) / N
    d = cc[:, None, :] - pos.numpy()[None]
    d -= np.round(d)
    np.testing.assert_array_equal(got, np.argmin((d**2).sum(-1), 1))


def test_nn_index_falls_back_past_the_block():
    """A void wider than the 3^3 block: cells are searched again."""
    n = 32
    pos = torch.tensor([[0.1, 0.1, 0.1], [0.12, 0.5, 0.9],
                        [0.9, 0.9, 0.2]], dtype=torch.float64)
    got = nn_velocity.nn_index(pos, n, 1.0, bucket=4).numpy()
    cc = (np.indices((n,) * 3).reshape(3, -1).T + 0.5) / n
    d = cc[:, None, :] - pos.numpy()[None]
    d -= np.round(d)
    np.testing.assert_array_equal(got, np.argmin((d**2).sum(-1), 1))


def test_shell_count_is_the_bin_formula():
    assert common.n_bins(1.0, 512) == 256
    assert common.n_bins(1.0, 1024) == 511


def test_bfloat16_control_departs(snap):
    psum, _ = scatter.cic_velocity(snap, N)
    low, _ = scatter.cic_velocity(snap, N, torch.bfloat16)
    assert np.max(np.abs(low - psum) / psum) > 1e-3
