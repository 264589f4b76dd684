"""PyTorch port of the command-line interface against the JAX package's, on
the CPU: the same snapshot (written by the JAX package, read by both),
the same options; the port's ``main(argv, device="cpu")`` against the
JAX ``main(argv + ["--single-chip"])`` (the JAX tests run on 8 virtual
CPU devices).  Then the port's own behaviour, ported from
``tests/test_cli.py``: resume, crash-resume, the rejections, the block
cache, routing by the plan, the parser, and the routes over a mesh of
CPU entries (the mesh scatter pipelines and the block-parallel streamed
sweep) against --single-chip.

Tolerances: Nsample bitwise everywhere; Psum to the tolerance of the
existing parity test of the function each route wraps (named beside
each route); ``betas_done.txt`` byte for byte; a resume byte for byte.
"""
import os

import jax
import numpy as np
import pytest
import torch

from vpower_tpu import save_snapshot as jsave_snapshot
from vpower_tpu import synthetic_particles as jsynthetic_particles
from vpower_tpu.parallel import planner as jplanner
from vpower_tpu.run import cli as jcli
from vpower_tpu_torch.io import snapshot as tsnapshot
from vpower_tpu_torch.io.synthetic import synthetic_particles
from vpower_tpu_torch.parallel import planner as tplanner
from vpower_tpu_torch.run import cli as tcli
from vpower_tpu_torch.run import pipeline as tpipe
from vpower_tpu_torch.run import streamed as tstreamed

torch.set_num_threads(1)

POWER_RTOL = 2e-6     # tests/test_torch_power.py PSUM_RTOL (unfolded)
FOLD_RTOL = 1e-6      # tests/test_torch_fold.py PSUM_RTOL (one fused beta)
SWEEP_RTOL = 3e-5     # tests/test_torch_fold.py SWEEP_RTOL (fused sweep)
STREAMED_RTOL = 1e-5  # tests/test_torch_streamed.py PSUM_RTOL

FOLDED = ["-N", "32", "-M", "16"]
ROUTES = {
    # name: (argv, Psum tolerance)
    "unfolded_cic_velocity": (["-N", "16", "--method", "cic",
                               "--quantity", "velocity"], POWER_RTOL),
    "fused_ngp_momentum": (FOLDED + ["--method", "ngp"], SWEEP_RTOL),
    "streamed_cic_velocity": (FOLDED + ["--method", "cic", "--quantity",
                                        "velocity", "--beta-batch", "3"],
                              STREAMED_RTOL),
    "streamed_nn_velocity": (FOLDED + ["--method", "nn", "--quantity",
                                       "velocity", "--margin", "8"],
                             STREAMED_RTOL),
    "streamed_nn_exact": (FOLDED + ["--method", "nn", "--quantity",
                                    "velocity", "--margin", "8", "--exact"],
                          STREAMED_RTOL),
    "streamed_sph_velocity": (FOLDED + ["--method", "sph", "--quantity",
                                        "velocity"], STREAMED_RTOL),
    "fused_cic_interlace_compensate": (
        FOLDED + ["--method", "cic", "--quantity", "momentum",
                  "--interlace", "--compensate"], FOLD_RTOL),
    "subsample_splice": (FOLDED + ["--method", "cic", "--quantity",
                                   "velocity", "--betas", "4", "--seed", "3"],
                         STREAMED_RTOL),
}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The snapshot of ``tests/test_cli.py``, written by the JAX package."""
    p = jsynthetic_particles(jax.random.PRNGKey(0), 16, jitter=0.4)
    path = str(tmp_path_factory.mktemp("snap") / "snap.hdf5")
    jsave_snapshot(path, p)
    return path


@pytest.fixture(scope="module", autouse=True)
def calib_paths(tmp_path_factory):
    """Both planners calibrate into files of this module's own."""
    d = tmp_path_factory.mktemp("calib")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jplanner, "_CALIB_PATH", str(d / "jax.json"))
        mp.setattr(tplanner, "_CALIB_PATH", str(d / "torch.json"))
        yield


def _out(base, name):
    path = os.path.join(str(base), name)
    os.makedirs(path)
    return path


def _run_port(snapshot, out, argv):
    return tcli.main(["-i", snapshot, "-o", out, "-f"] + argv, device="cpu")


def _run_jax(snapshot, out, argv):
    return jcli.main(["-i", snapshot, "-o", out, "-f"] + argv
                     + ["--single-chip", "--compile-cache", ""])


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, snapshot):
    """Each route's JAX output directory, run once for the module."""
    base = tmp_path_factory.mktemp("jax_cli")
    done = {}

    def get(name):
        if name not in done:
            out = _out(base, name)
            assert _run_jax(snapshot, out, ROUTES[name][0]) == 0
            done[name] = out
        return done[name]

    return get


def _pk(out, name="Pk.txt"):
    return np.loadtxt(os.path.join(out, name))


def _same_pk(got, ref, rtol):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])   # k
    np.testing.assert_array_equal(got[:, 3], ref[:, 3])   # Nsample
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=rtol,
                               atol=rtol * float(np.abs(ref[:, 2]).max()))


# ---------------------------------------------------------------------- #
# the routes against the JAX CLI                                      #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(ROUTES))
def test_cli_route_matches_jax(tmp_path, snapshot, jax_outputs, name):
    argv, rtol = ROUTES[name]
    out = _out(tmp_path, "port")
    assert _run_port(snapshot, out, argv) == 0
    ref = jax_outputs(name)
    ref_pk = _pk(ref)
    if "--interlace" in argv:
        # JAX rotates the shifted transform by e^{-i theta} (ROADMAP fault
        # F8): Psum is held to the port's fused sweep, which
        # tests/test_torch_fold.py holds to the JAX package's pipeline
        # with e^{+i theta}; k and Nsample stay the JAX CLI's
        args = tcli.build_parser().parse_args(["-i", snapshot, "-o", out]
                                              + argv)
        particles = tsnapshot.load_snapshot(snapshot, box_size=args.ltot,
                                            device="cpu")
        full = tpipe.fused_fold_full_spectrum(
            particles, 16, 2, method=args.method, interlace=True,
            compensate=True).data()
        np.testing.assert_array_equal(full[:, [0, 3]], ref_pk[:, [0, 3]])
        ref_pk = full
    _same_pk(_pk(out), ref_pk, rtol)
    assert sorted(f for f in os.listdir(out) if not f.endswith(".tmp")) == \
        sorted(f for f in os.listdir(ref) if not f.endswith(".tmp"))
    if "--betas" in argv or "-M" in argv:
        with open(os.path.join(out, "betas_done.txt"), "rb") as a, \
                open(os.path.join(ref, "betas_done.txt"), "rb") as b:
            assert a.read() == b.read()
    if "--betas" in argv:
        _same_pk(_pk(out, "Pk_full.txt"), _pk(ref, "Pk_full.txt"), rtol)


# ---------------------------------------------------------------------- #
# the port's own behaviour (tests/test_cli.py)                           #
# ---------------------------------------------------------------------- #
def test_cli_resume_and_crash_resume(tmp_path, snapshot):
    """A re-run recomputes nothing and leaves Pk.txt byte-identical; a
    crash between the commit points and the derived files (simulated by
    deleting Pk.txt and betas_done.txt) rebuilds them byte for byte,
    with no beta counted twice."""
    out = _out(tmp_path, "out")
    argv = FOLDED + ["--method", "ngp"]
    assert _run_port(snapshot, out, argv) == 0
    pk_path = os.path.join(out, "Pk.txt")
    with open(pk_path, "rb") as fh:
        complete = fh.read()
    pk = _pk(out)
    assert 0.4 * 32**3 < pk[:, 3].sum() < 0.6 * 32**3

    def no_beta(*a, **k):
        raise AssertionError("a resumed run recomputed a beta")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "fused_fold_spectrum", no_beta)
        assert _run_port(snapshot, out, argv) == 0
    with open(pk_path, "rb") as fh:
        assert fh.read() == complete

    os.remove(pk_path)
    os.remove(os.path.join(out, "betas_done.txt"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "fused_fold_spectrum", no_beta)
        assert _run_port(snapshot, out, argv) == 0
    with open(pk_path, "rb") as fh:
        assert fh.read() == complete
    assert len(open(os.path.join(out, "betas_done.txt")).readlines()) == 8


@pytest.mark.parametrize("argv", [
    FOLDED + ["--method", "cic", "--quantity", "velocity", "--interlace"],
    ["-N", "16", "--method", "nn", "--interlace"],
])
def test_cli_rejects_window_corrections(tmp_path, snapshot, argv):
    """Folded velocity streams (no window correction); a gather deposit
    has no window: both rejected up front, nothing written."""
    out = _out(tmp_path, "out")
    assert _run_port(snapshot, out, argv) == 1
    assert os.listdir(out) == []


def test_cli_block_cache_dir(tmp_path, snapshot):
    """--block-cache spills streamed block values to disk; a second run
    with the same cache reproduces the spectra from the stored blocks."""
    bc = str(tmp_path / "bcache")
    argv = FOLDED + ["--method", "cic", "--quantity", "velocity",
                     "--block-cache", bc]
    out = _out(tmp_path, "out")
    assert _run_port(snapshot, out, argv) == 0
    assert len([f for f in os.listdir(bc) if f.startswith("block_")]) == 8
    out2 = _out(tmp_path, "out2")

    def no_block(*a, **k):
        raise AssertionError("a cached block was deposited again")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstreamed, "_scatter_block_values", no_block)
        assert _run_port(snapshot, out2, argv) == 0
    np.testing.assert_allclose(_pk(out2), _pk(out), rtol=1e-6)


class _Routed(Exception):
    """Raised by the pipeline stubs below: carries which pipeline the CLI
    dispatched to, without paying for the run."""

    def __init__(self, kind):
        self.kind = kind


@pytest.mark.parametrize("method", ["ngp", "cic", "nn", "sph"])
@pytest.mark.parametrize("quantity", ["velocity", "momentum", "energy"])
def test_cli_routing_matches_plan(tmp_path, snapshot, monkeypatch,
                                  method, quantity):
    """For every (method x quantity) folded combination, the pipeline the
    CLI executes is the one the confirmed plan predicted."""
    def _stub(kind):
        def fn(*a, **k):
            raise _Routed(kind)
        return fn

    monkeypatch.setattr(tstreamed, "streamed_folded_sweep",
                        _stub("streamed"))
    monkeypatch.setattr(tpipe, "fused_fold_spectrum", _stub("fused"))
    out = _out(tmp_path, "out")
    with pytest.raises(_Routed) as exc:
        _run_port(snapshot, out, FOLDED + ["--method", method,
                                           "--quantity", quantity])
    plan = tplanner.plan_run(n_total=32, n_devices=1, n_particles=16**3,
                             hbm_bytes=tplanner.device_hbm_bytes("cpu"),
                             max_n_grid=16, method=method, quantity=quantity)
    assert exc.value.kind == ("streamed" if plan.streamed else "fused")
    assert plan.streamed == tplanner.streamed_pipeline(method, quantity,
                                                       plan.fold_m)


def _options(parser):
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_parser_matches_jax_less_compile_cache():
    """Every JAX option but --compile-cache, with the same flags, dest,
    default, choices, type and requiredness; no option of its own."""
    got, ref = _options(tcli.build_parser()), _options(jcli.build_parser())
    del ref["--compile-cache"]
    assert sorted(got) == sorted(ref)
    for flag, a in ref.items():
        b = got[flag]
        assert (b.option_strings, b.dest, b.default, b.choices, b.type,
                b.required, type(b)) == \
            (a.option_strings, a.dest, a.default, a.choices, a.type,
             a.required, type(a)), flag
    args = tcli.build_parser().parse_args(["-i", "a", "-o", "b"])
    assert args.ntot == 1000 and args.quantity == "momentum"
    assert "python -m vpower_tpu_torch.run.cli" in \
        tcli.build_parser().format_usage()


@pytest.mark.parametrize("argv", [
    ["-N", "16", "--method", "ngp"],                       # unfolded mesh
    FOLDED + ["--method", "ngp"],                          # fused mesh
    FOLDED + ["--method", "cic", "--interlace"],           # one card
])
def test_cli_multi_gpu_raises(tmp_path, snapshot, monkeypatch, capsys,
                              argv):
    """With a mesh of 8 CPU entries in sight and no --single-chip, the
    runs the JAX CLI puts on its scatter mesh pipelines raise nothing:
    the unfolded and fused routes call ``distributed_spectrum`` on the
    mesh once a beta and write the Pk.txt of the --single-chip run
    (Nsample equal, Psum within 1e-5); an --interlace run stays on one
    card, as the JAX CLI keeps it, with the JAX CLI's log line."""
    from vpower_tpu_torch import parallel as tparallel

    calls = []
    orig = tparallel.distributed_spectrum

    def spy(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(tparallel, "distributed_spectrum", spy)
    out_mesh = _out(tmp_path, "mesh")
    args = tcli.build_parser().parse_args(["-i", snapshot, "-o", out_mesh,
                                           "-f"] + argv)
    particles = tsnapshot.load_snapshot(snapshot, box_size=args.ltot,
                                        device="cpu")
    assert tcli._run_loaded(args, particles, "cpu",
                            mesh_devices=[torch.device("cpu")] * 8) == 0
    on_mesh = "--interlace" not in argv
    assert len(calls) == (0 if not on_mesh else 1 if argv[1] == "16"
                          else 8)
    assert all(mesh.size == 8 and mesh.devices.shape == (4, 2)
               for mesh in calls)
    if not on_mesh:
        assert "interlace/compensate run on the single-chip pipeline" \
            in capsys.readouterr().out
    out_one = _out(tmp_path, "one")
    assert _run_port(snapshot, out_one, argv + ["--single-chip"]) == 0
    _same_pk(_pk(out_mesh), _pk(out_one), 1e-5)


def test_cli_streamed_mesh_matches_single_chip(tmp_path, snapshot,
                                               monkeypatch):
    """The canonical folded-velocity NN run on a mesh of 8 CPU entries
    goes block-parallel through ``distributed_streamed_sweep`` and writes
    the Pk.txt of the forced single-device run (Nsample equal, Psum
    within the JAX test's 2e-4)."""
    from vpower_tpu_torch import parallel as tparallel

    base = FOLDED + ["--method", "nn", "--quantity", "velocity",
                     "--margin", "8", "--beta-batch", "4"]
    calls = []
    orig = tparallel.distributed_streamed_sweep

    def spy(*a, **k):
        calls.append(a[3])
        return orig(*a, **k)

    monkeypatch.setattr(tparallel, "distributed_streamed_sweep", spy)
    out_mesh = _out(tmp_path, "mesh")
    args = tcli.build_parser().parse_args(["-i", snapshot, "-o", out_mesh,
                                           "-f"] + base)
    particles = tsnapshot.load_snapshot(snapshot, box_size=args.ltot,
                                        device="cpu")
    assert tcli._run_loaded(args, particles, "cpu",
                            mesh_devices=[torch.device("cpu")] * 8) == 0
    (mesh,) = calls
    assert mesh.size == 8
    out_one = _out(tmp_path, "one")
    assert _run_port(snapshot, out_one, base + ["--single-chip"]) == 0
    assert len(calls) == 1
    _same_pk(_pk(out_mesh), _pk(out_one), 2e-4)
