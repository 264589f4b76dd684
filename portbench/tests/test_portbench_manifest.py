"""BENCHMARK.json against the benchmark's contract, and every name in
it found as a file of its own under ``portbench/``."""
import ast
import json
import re

import pytest

from portbench.harness import ROOT, cell_metrics, load_json, load_metric

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert (ROOT.parent / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("entry", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]])
def test_names(entry):
    assert NAME.match(entry), entry


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert _line(metric["layer"])
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert callable(load_metric(metric["name"]).read)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_moves_is_reported_by_each_listed_cell(metric):
    for cell in metric.get("workloads", CELLS):
        names = [m["name"] for m in cell_metrics(BENCH, cell, False)]
        assert metric["moves"] in names, (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert _line(entry["why"]) and entry["chips"] in (1, 4)
    spec = load_json("workloads", cell)
    assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    config = load_json("configs", spec["config"])
    traffic = load_json("traffic", spec["traffic"])
    assert all(k in config for k in traffic.get("args", []))
    mod, fn = traffic["reference"].split(":")
    assert (ROOT / "reference" / f"{mod}.py").exists()
    assert ":" in traffic["entry"]
    assert set(spec["limits"]) == {"psum_rel", "nsample_diff"}
    e2e = [m["name"] for m in cell_metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(BENCH, cell, True)


def test_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in (CELLS, [m["name"] for m in METRICS],
                  [c["name"] for c in BENCH["configs"]]):
        assert len(set(group)) == len(group)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = json.loads((ROOT.parent / config["file"]).read_text())
    assert data["source"] == config["source"] and _line(config["source"])
    assert data["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert NAME.match(key) and key in data and key in data["source_values"]
    for key, value in data["source_values"].items():
        assert data[key] == value or key in data["reduced"] \
            or key in data["assumed"], key
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_layers_of_one_name_agree():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"deposit", "spectrum", "kernels", "device"}


def test_command_names_no_file_outside_paths():
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("portbench/")


def test_files_are_named_from_name_characters():
    for path in ROOT.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_no_file_of_the_benchmark_imports_jax():
    for path in ROOT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "vpower_tpu"), (path, n)
