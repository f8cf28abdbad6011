"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import json
import re

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


@pytest.mark.parametrize("kind", ["configs", "traffic", "drivers", "metrics", "limits"])
def test_every_entry_finds_its_file(bench, kind):
    """Each configuration, mix, mix's driver, metric and cell has its file by name."""
    if kind == "configs":
        paths = [REPO / c["file"] for c in bench["configs"]]
    elif kind == "traffic":
        paths = [REPO / "benchmark" / "traffic" / f"{w['traffic']}.json"
                 for w in bench["workloads"]]
    elif kind == "drivers":
        paths = []
        for w in bench["workloads"]:
            with open(REPO / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
                paths.append(REPO / "benchmark" / "drivers" / f"{json.load(f)['driver']}.py")
    elif kind == "metrics":
        paths = [REPO / "benchmark" / "metrics" / f"{m['name']}.py"
                 for m in bench["end_to_end"] + bench["per_layer"]]
    else:
        paths = [REPO / "benchmark" / "limits" / f"{w['name']}.json" for w in bench["workloads"]]
    missing = [str(p) for p in paths if not p.is_file()]
    assert not missing


def test_configs_hold_what_they_run(bench):
    """reduced lists no width, and the file is as it is run: published widths whole."""
    for c in bench["configs"]:
        with open(REPO / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["decoder"]["vocab_size"] == 151936 and cfg["decoder"]["num_layers"] == 28


def test_find_cell_by_name(bench):
    from benchmark import harness

    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.cfg["name"] == w["config"] and cell.chips == w["chips"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "xrt"}
        assert cell.per_layer, "every cell reports a per-layer metric"
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no-such-cell")


def test_metric_workloads_list_cells_that_report_what_they_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells and w in e2e[m["moves"]].get("workloads", [w])


def test_parse_args():
    import importlib.util

    spec = importlib.util.spec_from_file_location("benchmark_run", REPO / "benchmark" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    args = run.parse_args(["--workload", "x", "--seed", str(2 ** 33 + 7), "--seconds", "10",
                           "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == ("x", 2 ** 33 + 7, 10.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device here: the command exits non-zero and prints no result."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "qwen3-asr-0.6b-4bit.longform-30s", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
