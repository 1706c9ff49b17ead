"""Everything a run needs, found by name under the benchmark's folder:

- `cells/<workload>.json`: the cell (its config, its traffic, its chips,
  the limits of its correctness numbers);
- `configs/<config>.json`: the deployment (the settings file it loads,
  the `Settings.system_config` arguments, the keys it cuts, the scene);
- `traffic/<mix>.json`: the traffic mix (motion, rates, warm-up, frame cap);
- `metrics/<metric>.py`: one per-layer metric, a `read(record)` function.

A later cell, configuration, mix or metric is a new file here; no file
that exists has to change.
"""
from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)

# names and units as BENCHMARK.json allows them
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")
UNIT_CHARS = NAME_CHARS | set("/%")


def valid_name(name: str) -> bool:
    return (0 < len(name) <= 64 and name[0] not in ".-"
            and set(name) <= NAME_CHARS)


def valid_unit(unit: str) -> bool:
    return 0 < len(unit) <= 16 and set(unit) <= UNIT_CHARS


def _load_json(kind: str, name: str) -> dict:
    if not valid_name(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(ROOT, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    c = _load_json("cells", name)
    c["name"] = name
    return c


def config(name: str) -> dict:
    c = _load_json("configs", name)
    c["name"] = name
    c["yaml_path"] = os.path.join(ROOT, "configs", c["yaml"])
    return c


def traffic(name: str) -> dict:
    t = _load_json("traffic", name)
    t["name"] = name
    return t


def names(kind: str) -> list:
    """Every name of one kind ('cells', 'configs', 'traffic', 'metrics')."""
    ext = ".py" if kind == "metrics" else ".json"
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(ROOT, kind))
                  if f.endswith(ext) and not f.startswith("_"))


def metric_reader(name: str):
    """The `read(record)` function of metrics/<name>.py."""
    if not valid_name(name):
        raise ValueError(f"bad metric name {name!r}")
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark() -> dict:
    """BENCHMARK.json at the checkout's root."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def per_layer_for(workload: str) -> list:
    """(name, unit) of the per-layer metrics BENCHMARK.json lists for this
    workload: those with no `workloads` key, and those that name it."""
    return [(m["name"], m["unit"]) for m in benchmark()["per_layer"]
            if workload in m.get("workloads", [workload])]
