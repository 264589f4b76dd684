"""Runs of the harness on the CPU at a small size: the result line's
schema, cells, configurations and metrics found by name as new files,
the control and the faults each coming out as not correct."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import ROOT, run_cell

SMALL = {"n_grid": 16, "snapshot": {"n_lattice": 12, "jitter": 3.0,
                                    "n_field": 16, "box_size": 1.0,
                                    "spectral_index": -11.0 / 3.0}}
NN_SMALL = dict(SMALL, n_grid=32, snapshot=dict(SMALL["snapshot"],
                                                n_lattice=24))
SEED = 2**31 + 99
CELLS = {"g512_nn_vel": NN_SMALL, "g512_cic_vel": SMALL,
         "r1024_fold_mom": dict(SMALL, n_grid=8)}


def _run(cell, trace=False, **kw):
    kw.setdefault("overrides", CELLS[cell])
    return run_cell(cell, SEED, 0.2, trace, device="cpu", **kw)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_schema(cell, trace):
    r = _run(cell, trace)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    if not trace:
        assert "setup_s" in line["metrics"]
        assert {"spectrum_s", "spectrum_s.launch"} & set(line["metrics"])
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _copy(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark."""
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    return tmp_path / "portbench"


def test_new_config_cell_and_metric_are_files_found_by_name(tmp_path):
    root = _copy(tmp_path)
    cfg = json.loads((root / "configs" / "snap10m_g512.json").read_text())
    cfg["n_grid"] = 8
    (root / "configs" / "tiny_g8.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "g512_cic_vel.json").read_text())
    cell["config"] = "tiny_g8"
    (root / "workloads" / "tiny_cic.json").write_text(json.dumps(cell))
    (root / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return float(len(run.walls))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_cic", "config": "tiny_g8",
                               "traffic": "cic_velocity", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "count",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny_cic"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell("tiny_cic", SEED, 0.1, False, device="cpu", root=root,
                 overrides={"snapshot": SMALL["snapshot"]})
    assert r["correct"]
    assert r["metrics"]["calls_made"]["value"] == r["attempted"]


def _entry(traffic_entry, breaker):
    from portbench.harness import resolve

    orig = resolve(traffic_entry)

    def broken(particles, *args, **kwargs):
        return breaker(orig, particles, args, kwargs)

    return broken


def _half_particles(orig, p, args, kwargs):
    return orig(p[: len(p) // 2], *args, **kwargs)


def _altered_answer(orig, p, args, kwargs):
    out = orig(p, *args, **kwargs).copy()
    out.Psum[len(out.Psum) // 2] *= 1.05
    return out


def _nan_bin(orig, p, args, kwargs):
    out = orig(p, *args, **kwargs).copy()
    out.Psum[len(out.Psum) // 2] = np.nan
    return out


def _nan_count(orig, p, args, kwargs):
    out = orig(p, *args, **kwargs).copy()
    out.Nsample[len(out.Nsample) // 2] = np.nan
    return out


def _half_betas(orig, p, args, kwargs):
    from vpower_tpu_torch import init_beta_space

    betas = init_beta_space(args[1])
    return orig(p, *args, beta_sequence=betas[: len(betas) // 2], **kwargs)


_SPECTRUM = "vpower_tpu_torch.run.pipeline:power_spectrum"
_FOLD = "vpower_tpu_torch.run.pipeline:fused_fold_full_spectrum"
FAULTS = [(cell, entry, breaker)
          for cell, entry in (("g512_nn_vel", _SPECTRUM),
                              ("g512_cic_vel", _SPECTRUM),
                              ("r1024_fold_mom", _FOLD))
          for breaker in (_half_particles, _altered_answer, _nan_bin,
                          _nan_count)] + \
    [("r1024_fold_mom", _FOLD, _half_betas)]


@pytest.mark.parametrize("cell, entry, breaker", FAULTS,
                         ids=[f"{c}-{b.__name__[1:]}" for c, _, b in FAULTS])
def test_fault_is_not_correct(cell, entry, breaker):
    r = _run(cell, entry=_entry(entry, breaker))
    assert r["correct"] is False and r["failed"] == r["attempted"]


def _control_run(cell, device, overrides):
    """A run with the reference rounded to bfloat16 in the program's
    place."""
    from portbench.harness import control_entry

    return run_cell(cell, SEED, 0.2, False, device=device,
                    overrides=overrides,
                    entry=control_entry(cell, SEED, device,
                                        overrides=overrides))


@pytest.mark.parametrize("cell", ["g512_cic_vel", "r1024_fold_mom"])
def test_control_is_not_correct(cell):
    r = _control_run(cell, "cpu", CELLS[cell])
    assert r["correct"] is False
    assert r["checks"]["psum_rel"]["value"] > \
        r["checks"]["psum_rel"]["limit"]


@pytest.mark.cuda
def test_nn_control_is_not_correct_at_the_cells_size():
    """bfloat16 positions move a particle by up to a cell only at the
    cell's own 512^3 (at 32^3 by a sixteenth), so the NN control runs
    on the card at full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _control_run("g512_nn_vel", "cuda:0", {})
    assert r["correct"] is False
    assert r["checks"]["psum_rel"]["value"] > \
        r["checks"]["psum_rel"]["limit"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    res = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload",
                          "g512_cic_vel", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT.parent, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """Without the program beside it, a run fails and prints nothing."""
    _copy(tmp_path)
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from portbench.harness import run_cell; "
            "run_cell('g512_cic_vel', 1, 0.1, False, device='cpu')")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "vpower_tpu_torch" in res.stderr


def test_a_run_loads_no_jax(tmp_path):
    """Top-level module names compared whole after a CPU run."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "from portbench.harness import run_cell; "
            f"run_cell('g512_cic_vel', 1, 0.1, True, device='cpu', "
            f"overrides={SMALL!r}); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code, str(ROOT.parent)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "vpower_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "vpower_tpu"}


_LOADS_JAX = ("import sys, pathlib\n"
              "sys.path.insert(0, str(pathlib.Path(__file__).resolve()"
              ".parents[2] / 'stub'))\n"
              "import jax  # noqa: F401\n")


@pytest.mark.parametrize("where", ["metric", "reference"])
def test_jax_loaded_after_the_window_gives_no_result(tmp_path, where):
    """A metric's reader, or the reference, that loads a module named
    ``jax`` once the window has closed: the run exits non-zero, names
    it and prints no result line."""
    root = _copy(tmp_path)
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    if where == "metric":
        (root / "metrics" / "loads_jax.py").write_text(
            _LOADS_JAX + "\n\ndef read(run):\n    return 1.0\n")
        bench["end_to_end"].append({"name": "loads_jax", "unit": "count",
                                    "better": "lower", "bound": 0.01,
                                    "source": "host_clock"})
    else:
        (root / "reference" / "loads_jax.py").write_text(
            _LOADS_JAX + "from portbench.reference.scatter import "
            "cic_velocity  # noqa: E402,F401\n")
        traffic = json.loads((root / "traffic" / "cic_velocity.json")
                             .read_text())
        traffic["reference"] = "loads_jax:cic_velocity"
        (root / "traffic" / "cic_velocity.json").write_text(
            json.dumps(traffic))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from portbench.harness import run_cell; "
            "r = run_cell('g512_cic_vel', 1, 0.1, False, device='cpu', "
            f"overrides={SMALL!r}); print(json.dumps(r))")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(ROOT.parent)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == "", res.stdout
    assert "modules of JAX" in res.stderr and "jax" in res.stderr


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "math",
                                           "typing", "__future__"), (path, m)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the CIC cell on the card: correct, and every
    end-to-end metric of the cell reported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload",
                          "g512_cic_vel", "--seed", str(SEED), "--seconds",
                          "2", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT.parent, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"setup_s", "spectrum_s", "spectrum_p90_s", "peak_gib"} == \
        set(line["metrics"])
    np.testing.assert_array_less(0.0, [m["value"]
                                       for m in line["metrics"].values()])
