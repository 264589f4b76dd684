"""PyTorch port of the run planner and the profiling utilities against the
JAX package, on the CPU.

The planner's structure (routing predicate, mesh factorization,
divisibility rule, fold loop, calibration) is held to the JAX one with
the port's constants replaced by the JAX package's: the estimates and
plans must then be equal.  The port's own constants, fitted to the
port's measured peaks on an H100, are asserted separately.  The
profiling utilities print the JAX package's text.
"""
import itertools
import os
import subprocess
import sys

import pytest
import torch

from vpower_tpu.parallel import mesh as jmesh
from vpower_tpu.parallel import planner as jplanner
from vpower_tpu.utils import profiling as jprof
from vpower_tpu_torch.parallel import mesh as tmesh
from vpower_tpu_torch.parallel import planner as tplanner
from vpower_tpu_torch.utils import profiling as tprof

METHODS = ("ngp", "cic", "nn", "sph")
QUANTITIES = ("velocity", "momentum", "energy")
N_BENCH = 10_077_696  # chip_smoke.py's particles
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def calib(tmp_path, monkeypatch):
    """Both planners calibrate into files of the test's own."""
    monkeypatch.setattr(jplanner, "_CALIB_PATH", str(tmp_path / "jax.json"))
    monkeypatch.setattr(tplanner, "_CALIB_PATH", str(tmp_path / "torch.json"))
    return tmp_path


@pytest.fixture()
def jax_constants(calib, monkeypatch):
    """The port's planner with the JAX package's constants."""
    monkeypatch.setattr(tplanner, "_CUBES_REAL",
                        {m: jplanner._CUBES_REAL for m in METHODS})
    monkeypatch.setattr(tplanner, "_CUBES_COMPLEX", jplanner._CUBES_COMPLEX)
    monkeypatch.setattr(tplanner, "_NN_BYTES_PER_CELL",
                        jplanner._NN_BYTES_PER_CELL)


def test_mesh_shape_for_matches_jax():
    for n in range(1, 65):
        assert tmesh.mesh_shape_for(n) == jmesh.mesh_shape_for(n)


def test_streamed_pipeline_matches_jax():
    for method, quantity, m in itertools.product(METHODS, QUANTITIES,
                                                 range(1, 9)):
        assert tplanner.streamed_pipeline(method, quantity, m) == \
            jplanner.streamed_pipeline(method, quantity, m)
        assert tplanner._pipeline_kind(method, quantity, m) == \
            jplanner._pipeline_kind(method, quantity, m)


@pytest.mark.parametrize("n_total", [32, 64, 512, 1024, 2048])
@pytest.mark.parametrize("hbm", [16e9, 80e9])
def test_plan_and_estimate_match_jax_with_jax_constants(jax_constants,
                                                        n_total, hbm):
    """Over (method x quantity) x max_n_grid x beta_batch x certify, the
    plan (or the infeasible-plan error) and its estimates equal the JAX
    ones; so do the estimates of each fold that divides the range, on
    one device and on four."""
    n_p = N_BENCH if n_total >= 512 else n_total**3 // 8
    for method, quantity, max_n, bb, certify in itertools.product(
            METHODS, QUANTITIES, (None, 256, 512), (1, 4, 8),
            (True, False)):
        kw = dict(n_particles=n_p, max_n_grid=max_n, method=method,
                  quantity=quantity, beta_batch=bb, certify=certify)
        try:
            ref = jplanner.plan_run(n_total, 1, hbm_bytes=hbm, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match="No feasible plan") as got:
                tplanner.plan_run(n_total, 1, hbm_bytes=hbm, **kw)
            assert str(got.value) == str(e)
            continue
        got = tplanner.plan_run(n_total, 1, hbm_bytes=hbm, **kw)
        assert got == tplanner.Plan(**vars(ref))
        assert got.describe() == ref.describe()
    for method, quantity, m, ndev, certify in itertools.product(
            METHODS, QUANTITIES, (1, 2, 4, 8), (1, 4), (True, False)):
        if n_total % m:
            continue
        kw = dict(method=method, quantity=quantity, fold_m=m, beta_batch=4,
                  certify=certify)
        assert tplanner.estimate_peak_bytes(n_total // m, ndev, n_p, **kw) \
            == jplanner.estimate_peak_bytes(n_total // m, ndev, n_p, **kw)


def test_infeasible_plan_raises_as_jax(jax_constants):
    kw = dict(n_particles=10**12, method="ngp", quantity="velocity")
    with pytest.raises(ValueError) as ref:
        jplanner.plan_run(64, 1, hbm_bytes=1e6, **kw)
    with pytest.raises(ValueError) as got:
        tplanner.plan_run(64, 1, hbm_bytes=1e6, **kw)
    assert str(got.value) == str(ref.value)


# the CLI's routes on 10,077,696 particles: measured peaks in GiB
# (max_memory_allocated with the particles held; tools/cli_peaks.py,
# NVIDIA H100 80GB HBM3, 700 W), and the plan's arguments
MEASURED_PEAKS = [
    (10.978, dict(n_grid=512, method="nn", quantity="velocity")),
    (7.847, dict(n_grid=512, method="nn", quantity="velocity")),  # exact
    (6.814, dict(n_grid=512, method="ngp", quantity="velocity")),
    (6.814, dict(n_grid=512, method="cic", quantity="velocity")),
    (6.814, dict(n_grid=512, method="sph", quantity="velocity")),
    (7.096, dict(n_grid=512, fold_m=2)),      # -N 1024 -M 512
    (7.930, dict(n_grid=256, fold_m=8, method="nn", quantity="velocity",
                 beta_batch=8)),             # range 2048
]


@pytest.mark.parametrize("peak,kw", MEASURED_PEAKS)
def test_port_constants_cover_the_cards_peaks(calib, peak, kw):
    """Each route's estimate lies between the port's measured peak on an
    H100 and twice it."""
    kw = dict(kw)
    est = tplanner.estimate_peak_bytes(kw.pop("n_grid"), 1, N_BENCH,
                                       **kw) / 2**30
    assert peak <= est <= 2 * peak


def test_port_plans_fold_where_the_card_needs_it(calib):
    """A 1024^3 NN velocity plan on the card's memory folds (the JAX
    constants plan an unfolded 1024^3 grid the card cannot hold), and
    the README run, -N 1024 -M 512, is the fused sweep at m = 2."""
    plan = tplanner.plan_run(1024, 1, hbm_bytes=80e9, n_particles=N_BENCH,
                             method="nn", quantity="velocity")
    assert plan.fold_m >= 2 and plan.streamed
    assert plan.bytes_per_device <= 0.9 * 80e9
    jplan = jplanner.plan_run(1024, 1, hbm_bytes=80e9, n_particles=N_BENCH,
                              method="nn", quantity="velocity")
    assert jplan.fold_m == 1
    plan = tplanner.plan_run(1024, 1, hbm_bytes=80e9, n_particles=N_BENCH,
                             max_n_grid=512)
    assert (plan.fold_m, plan.n_grid, plan.streamed) == (2, 512, False)


def test_planner_calibration_roundtrip(calib):
    """Measured peaks recorded by the CLI feed back into the next plan's
    estimate: a 2x-underestimating constant self-corrects (ported from
    ``tests/test_extras.py``); the default file is the port's own."""
    planner = tplanner
    assert planner.calibration_factor("scatter") == 1.0
    plan = planner.plan_run(64, 1, hbm_bytes=16e9, n_particles=10000,
                            method="ngp", quantity="momentum")
    before = plan.bytes_per_device
    planner.record_measured_peak(plan, measured_bytes=2.0 * before)
    assert abs(planner.calibration_factor("scatter") - 2.0) < 1e-6
    plan2 = planner.plan_run(64, 1, hbm_bytes=16e9, n_particles=10000,
                             method="ngp", quantity="momentum")
    assert abs(plan2.bytes_per_device / before - 2.0) < 0.01
    # other pipeline kinds are unaffected
    assert planner.calibration_factor("streamed") == 1.0
    # clamped against one wild record
    planner.record_measured_peak(plan, measured_bytes=100.0 * before)
    assert planner.calibration_factor("scatter") <= 4.0
    assert (calib / "torch.json").exists()
    assert not (calib / "jax.json").exists()


def test_default_calibration_path_is_the_ports(tmp_path):
    """Without ``VPOWER_CALIB_PATH`` the port calibrates into
    ``~/.cache/vpower_tpu_torch/``, never the JAX package's file."""
    env = {k: v for k, v in os.environ.items() if k != "VPOWER_CALIB_PATH"}
    env.update(HOME=str(tmp_path), PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", "from vpower_tpu_torch.parallel import "
         "planner; print(planner._CALIB_PATH)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(
        tmp_path / ".cache" / "vpower_tpu_torch" / "planner_calib.json")
    assert res.stdout.strip() != jplanner._CALIB_PATH


def test_device_memory_on_the_cpu():
    assert tplanner.device_hbm_bytes("cpu") == 16e9
    assert tplanner.measured_peak_bytes("cpu") is None


# ---------------------------------------------------------------------- #
# profiling                                                               #
# ---------------------------------------------------------------------- #
class _Clock:
    """A ``time.perf_counter`` that advances by fixed steps."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 1.0
        return self.t


def _patch_clock(monkeypatch, mod, steps):
    monkeypatch.setattr(mod.time, "perf_counter", _Clock(steps))


def test_stage_timer_report_matches_jax(monkeypatch):
    reports = []
    for mod in (jprof, tprof):
        with monkeypatch.context() as mp:
            _patch_clock(mp, mod, [0.0, 0.25, 1.0, 2.5, 3.0, 3.125])
            timer = mod.StageTimer()
            with timer("deposit"):
                pass
            with timer("fft"):
                timer.observe(torch.zeros(2) if mod is tprof else None)
            with timer("deposit"):
                pass
            reports.append((timer.report(), timer.total("deposit")))
    assert reports[0] == reports[1]
    assert "deposit" in reports[0][0] and "x2" in reports[0][0]


def test_progress_matches_jax(monkeypatch, capsys):
    outs = []
    for mod in (jprof, tprof):
        with monkeypatch.context() as mp:
            _patch_clock(mp, mod, [0.0, 2.0, 3.5, 7.25])
            p = mod.Progress(total=3, enabled=True)
            p.update(1.0, stage="beta (0, 0, 1)")
            p.update(1.0)
            p.update(1.0, stage="beta (1, 1, 1)")
            mod.Progress(total=2, enabled=False).update(1.0)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].endswith("\n") and "100.0%" in outs[0]


def test_log_matches_jax(monkeypatch, capsys):
    import datetime as dt

    class _Now(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5, 6)

    outs = []
    for mod in (jprof, tprof):
        with monkeypatch.context() as mp:
            mp.setattr(mod.datetime, "datetime", _Now)
            mod.log("Plan confirmed.")
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == "[2026-01-02 03:04:05.000006] " \
        "Plan confirmed.\n"


def test_sync_and_trace_on_the_cpu(tmp_path):
    """``sync`` is a no-op on CPU tensors and containers of them; ``trace``
    writes a trace file of ``torch.profiler``."""
    tprof.sync(torch.ones(3))
    tprof.sync({"a": [1, (torch.ones(2),)]})
    tprof.sync([1, "x"])
    with tprof.trace(str(tmp_path)):
        torch.ones(64).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
