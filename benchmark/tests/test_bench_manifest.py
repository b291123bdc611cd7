"""BENCHMARK.json against the benchmark's contract, and the discovery of
every configuration, traffic mix, limits file, metric reader and kernel
count by name."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.manifest(ROOT)


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    assert (ROOT / man["command"][1]).is_file()
    assert len(json.dumps(man)) < 64 * 1024


def test_configs(man):
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
        assert 0 < len(c["why"]) <= 200 and 0 < len(c["source"]) <= 200


def test_workloads_are_found_by_name(man):
    cfgs = {c["name"] for c in man["configs"]}
    used = set()
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
        used.add(w["config"])
        cell = manifest.cell(w["name"], ROOT)
        assert cell.traffic["batch"] >= 1 and cell.traffic["ring_requests"] >= 1
        assert set(cell.limits) <= {"kp_unmatched", "kp_field_gap",
                                    "row_unmatched_share", "desc_max_gap"}
        for spec in cell.limits.values():
            assert spec["lower"] < spec["limit"] < spec["upper"]
    assert used == cfgs
    with pytest.raises(KeyError):
        manifest.cell("no.such.cell", ROOT)


def test_metrics(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    names = set()
    for m in man["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert 0 < len(m["layer"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert callable(manifest.metric_reader(m["name"], ROOT))
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_roofline_files():
    table = manifest.kernel_table(ROOT)
    assert set(table) == {"blur_kernel", "chain_kernel", "detect_kernel",
                          "orientation_kernel", "descriptor_kernel"}
    for stages in table.values():
        for st in stages:
            assert callable(manifest.stage_counter(st, ROOT))
    assert manifest.peaks("NVIDIA H100 80GB HBM3", ROOT) == (3.35e12, 67e12)
    assert manifest.peaks("cpu", ROOT) is None


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A new configuration, traffic mix, limits file, metric and kernel count
    are found with no edit of a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "tum640_hessian.json").read_text())
    cfg.update(name="vga_hessian", height=480, width=640)
    (root / "benchmark/configs/vga_hessian.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/b4_describe.json").write_text(json.dumps(
        {"batch": 4, "ring_requests": 2, "sift": {},
         "sample_requests": 2, "trace_requests": 4}))
    (root / "benchmark/limits/vga.describe.b4.json").write_text(
        (BENCH / "limits/tum640.describe.b16.json").read_text())
    (root / "benchmark/metrics/frames_per_request.py").write_text(
        "def read(run):\n    return run.frames / max(run.requests, 1)\n")
    (root / "benchmark/roofline/kernels/extra_kernel.json").write_text(
        json.dumps({"symbol": "extra_kernel", "stages": ["blur"]}))
    man["configs"].append({"name": "vga_hessian", "source": "x",
                           "file": "benchmark/configs/vga_hessian.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "vga.describe.b4",
                             "config": "vga_hessian",
                             "traffic": "b4_describe", "chips": 1,
                             "why": "x"})
    man["per_layer"].append({"name": "frames_per_request", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "frames_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell("vga.describe.b4", root)
    assert cell.traffic["batch"] == 4 and cell.config["name"] == "vga_hessian"
    assert [m["name"] for m in cell.per_layer][-1] == "frames_per_request"
    assert "frames_per_request" in [     # every cell reads every metric
        m["name"] for m in manifest.cell("tum640.describe.b16", root).per_layer]
    assert manifest.kernel_table(root)["extra_kernel"] == ["blur"]

    class Run:
        frames, requests = 8, 2
    assert manifest.metric_reader("frames_per_request", root)(Run) == 4
