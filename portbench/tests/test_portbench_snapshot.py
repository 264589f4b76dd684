"""The frozen snapshot generator: the same seed gives the same particles."""
import torch

from portbench.snapshot import make_snapshot

RECIPE = {"n_field": 8, "n_lattice": 6, "jitter": 3.0, "box_size": 1.0,
          "spectral_index": -11.0 / 3.0}
SEED = 2**31 + 12345          # beyond 32 signed bits, as the driver's are


def test_same_seed_same_particles():
    a, b = make_snapshot(RECIPE, SEED, "cpu"), make_snapshot(RECIPE, SEED,
                                                             "cpu")
    for k in ("pos", "vel", "mass", "density"):
        assert torch.equal(a[k], b[k])


def test_other_seed_other_particles():
    a, b = make_snapshot(RECIPE, SEED, "cpu"), make_snapshot(RECIPE,
                                                             SEED + 1, "cpu")
    assert not torch.equal(a["pos"], b["pos"])
    assert not torch.equal(a["vel"], b["vel"])


def test_shapes_and_box():
    s = make_snapshot(RECIPE, SEED, "cpu")
    n = RECIPE["n_lattice"] ** 3
    assert s["pos"].shape == (n, 3) and s["vel"].shape == (n, 3)
    assert s["pos"].dtype == torch.float32
    assert bool(((s["pos"] >= 0) & (s["pos"] <= 1.0)).all())
    assert abs(float(s["mass"].double().sum()) - 1.0) < 1e-6
