"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric, kernel count or cell lives in a file of its own:

    benchmark/configs/<config>.json      (the path BENCHMARK.json gives)
    benchmark/traffic/<traffic>.json
    benchmark/metrics/<metric>.py        (read(run) -> number or None)
    benchmark/limits/<workload>.json     (the limits of `correct`)
    benchmark/roofline/<stage>.py        (launches(ctx) -> {launch: (bytes,
                                          operations)})
    benchmark/roofline/kernels/*.json    ({"symbol", "stages"})
    benchmark/roofline/peaks.json
    benchmark/reference/<reference>.py   (the configuration's reference)

so that a new cell, mix, metric or kernel count is new files and entries,
never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]    # every cell reads each metric; a reader
    per_layer: List[dict]     # that finds nothing returns None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of BENCHMARK.json with its configuration, traffic
    mix, limits and metrics; KeyError if there is no such workload."""
    man = manifest(root)
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(wl)}")
    w = wl[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    config = load_json(root / cfgs[w["config"]]["file"])
    bench = root / "benchmark"
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                man["end_to_end"], man["per_layer"])


def load_module(path: Path, name: str) -> ModuleType:
    """The module of the file `path`, loaded once a process under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The read(run) function of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    return load_module(path, f"bench_metric_{name.replace('.', '_')}").read


def reference(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "benchmark" / "reference" / f"{name}.py",
                       f"bench_reference_{name}")


def kernel_table(root: Path = ROOT) -> Dict[str, List[str]]:
    """{kernel symbol: [stages it does]} from roofline/kernels/*.json."""
    out = {}
    for p in sorted((root / "benchmark" / "roofline" / "kernels").glob(
            "*.json")):
        k = load_json(p)
        out[k["symbol"]] = list(k["stages"])
    return out


def stage_counter(stage: str, root: Path = ROOT):
    """The launches(ctx) function of roofline/<stage>.py."""
    path = root / "benchmark" / "roofline" / f"{stage}.py"
    return load_module(path, f"bench_roofline_{stage}").launches


def peaks(kind: str, root: Path = ROOT):
    """(bytes/s, operations/s) of the card named `kind`, or None."""
    table = load_json(root / "benchmark" / "roofline" / "peaks.json")
    for entry in table["cards"]:
        if entry["match"] in kind:
            return float(entry["bytes_per_s"]), float(entry["flops_per_s"])
    return None
