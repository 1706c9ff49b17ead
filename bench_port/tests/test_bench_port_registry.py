"""The benchmark's files found by name, BENCHMARK.json against them, the
result line's form and the import guard. CPU only, no System is run.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import ast
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPO = os.path.dirname(ROOT)
sys.path.insert(0, REPO)

from bench_port import run as bench_run  # noqa: E402
from bench_port.harness import registry, run_cell  # noqa: E402
from bench_port.reference import judge  # noqa: E402

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found_by_name(w):
    cell = registry.cell(w["name"])
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    assert cell["chips"] == w["chips"] == 1
    assert cell["why"] == w["why"] and len(w["why"]) <= 200
    cfg = registry.config(w["config"])
    assert os.path.isfile(cfg["yaml_path"])
    registry.traffic(w["traffic"])
    assert set(cell["limits"]) <= set(judge.NUMBERS)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_and_cuts(c):
    assert c["file"] == f"bench_port/configs/{c['name']}.json"
    cfg = registry.config(c["name"])
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for key, cut in cfg["reduced"].items():
        assert {"field", "value", "published"} <= set(cut), key


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    read = registry.metric_reader(m["name"])
    empty = {"frames": 0, "timing": {}, "spans": {}, "slice": {}}
    assert read(empty) is None           # nothing to read: no number
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in BENCH["workloads"]}


def test_every_file_is_named_in_the_benchmark():
    assert registry.names("metrics") == sorted(
        m["name"] for m in BENCH["per_layer"])
    assert registry.names("cells") == sorted(
        w["name"] for w in BENCH["workloads"])
    assert registry.names("configs") == sorted(
        c["name"] for c in BENCH["configs"])


def test_names_and_units():
    things = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
              + BENCH["per_layer"])
    for t in things:
        assert registry.valid_name(t["name"]), t["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert registry.valid_unit(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(registry.valid_name(k) for k in c["reduced"])
    assert not registry.valid_name("a b") and not registry.valid_name("a/b")
    assert not registry.valid_unit("tokens per second")


def _res(trace: bool) -> dict:
    return {"cell": "kitti00-02-stereo.drive", "trace": trace,
            "attempted": 3, "failed": 0, "frames_per_s": 2.0,
            "latency_ms": [500.0, 600.0, 700.0], "setup_s": 20.0,
            "memory_peak_bytes": 1, "device": "NVIDIA H100 80GB HBM3",
            "per_layer": {"track.host_ms": 300.0},
            "slice": {"busy_s": 0.1, "window_s": 1.0,
                      "device_ops": [["k", 0.01]], "idle_gaps": [["c", 0.5]]},
            "checks": {"ate_pct": {"value": 0.1, "max": 2.0, "ok": True}}}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    line = run_cell.result_line(_res(trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]       # the compared ones last
    assert line["correct"] is True
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"frames_per_s", "frame_p95_ms",
                                        "setup_s"}
    json.dumps(line)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub: str):
    for dirpath, _, files in os.walk(os.path.join(ROOT, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("sub", ["harness", "reference", "scenes",
                                 "metrics"])
def test_no_jax_imports(sub):
    for path in list(_sources(sub)) + [os.path.join(ROOT, "run.py")]:
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "ms_slam_tpu"}, path


def test_reference_imports_nothing_of_the_port():
    for path in list(_sources("reference")) + list(_sources("scenes")):
        assert "ms_slam_tpu_torch" not in _imports(path), path


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ms_slam_tpu_torch_fake", sys)
    assert "ms_slam_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ms_slam_tpu.sub", sys)
    assert bench_run.forbidden_modules() == ["ms_slam_tpu"]
