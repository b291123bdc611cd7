"""A run of the harness without the look for a card, on the CPU at a tiny
size, with the timed path broken underneath: `correct` has to come out
false for each fault a cell can have (an answer left as it was, half of
the batch left out, an answer altered where it is produced) and true
without one. After such a run no module of JAX or of the JAX package is
loaded."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import cell as bench  # noqa: E402
from benchlib import manifest  # noqa: E402
from benchlib.program import Program  # noqa: E402


def tiny(name: str) -> manifest.Cell:
    c = manifest.cell(name, ROOT)
    return c._replace(
        config={**c.config, "height": 120, "width": 160,
                "frames": {"density": 0.0066}},
        traffic={**c.traffic, "batch": 2, "ring_requests": 2,
                 "sample_requests": 4,
                 "trace_requests": 2})


class Broken(Program):
    """The program with one fault planted where its answer is produced."""
    fault = None

    def __init__(self, root, sift, device):
        super().__init__(root, sift, device)
        self.previous = None

    def __call__(self, frames):
        out = super().__call__(frames)
        if self.fault == "unchanged":       # the last answer handed back
            out, self.previous = (self.previous or out), out
        elif self.fault == "half_batch":    # frames past the half left out
            h = out.valid.shape[0] // 2
            valid = out.valid.clone()
            valid[h:] = False
            out = out._replace(valid=valid)
        elif self.fault == "altered":       # one feature moved 0.25 px
            x = out.x.clone()
            first = int(out.valid[0].nonzero()[0, 0])
            x[0, first] += 0.25
            out = out._replace(x=x)
        return out


def run(name, fault, traced=False):
    Broken.fault = fault
    return bench.run_cell(tiny(name), 2 ** 31 + 99, 0.5, traced,
                          time.perf_counter(), device="cpu", root=ROOT,
                          program_factory=Broken)


@pytest.mark.parametrize("name", ["tum640.describe.b16",
                                  "tum640.detect_only.b16"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    r = run(name, fault)
    assert r["correct"] is False, r["checks"]


def test_a_single_frame_cell_with_an_altered_answer_is_not_correct():
    r = run("eth3d24mp.describe.b1", "altered")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("traced", [False, True])
def test_an_unbroken_run_is_correct(traced):
    r = run("tum640.describe.b16", None, traced)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "extra"]
    want = {m["name"] for m in (tiny("tum640.describe.b16").per_layer
                                if traced else
                                tiny("tum640.describe.b16").end_to_end)}
    assert set(r["metrics"]) <= want
    if not traced:
        assert set(r["metrics"]) == want      # every end-to-end metric
    else:
        assert "enqueue_ms" in r["metrics"]
        assert r["device"]["window_s"] > 0


def test_no_jax_after_a_dry_run():
    """A CPU run of the harness in a fresh process: no loaded module has
    the top-level name jax, jaxlib, flax or hessgpu_tpu (hessgpu_tpu_torch,
    whose name starts with the JAX package's, passes)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "from test_bench_faults import run\n"
        "r = run('tum640.detect_only.b16', None)\n"
        "from benchlib.cell import forbidden_modules\n"
        "print(r['correct'], forbidden_modules(),"
        " 'hessgpu_tpu_torch' in sys.modules)\n"
        % (str(BENCH), str(Path(__file__).parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True [] True"


PLANTED = (
    "import sys\n"
    "from pathlib import Path\n"
    "sys.path.insert(0, str(Path(__file__).parent / 'stub'))\n"
    "import jax  # noqa: F401,E402\n\n\n"
    "def read(run):\n"
    "    return 1.0\n")


@pytest.mark.parametrize("planted", [False, True])
def test_jax_loaded_by_a_metric_reader_refuses_the_result(tmp_path, planted):
    """A checkout whose BENCHMARK.json names a metric whose reader imports
    a module named jax (a stub): run.py's report runs the window, the
    reference and the readers, then exits 5 with no result line; the same
    checkout without that metric exits 0 with one."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "hessgpu_tpu_torch", root / "hessgpu_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = tiny("tum640.detect_only.b16")
    (root / man["configs"][0]["file"]).write_text(json.dumps(c.config))
    (root / "benchmark/traffic/b16_detect_only.json").write_text(
        json.dumps(c.traffic))
    if planted:
        stub = root / "benchmark/metrics/stub/jax"
        stub.mkdir(parents=True)
        (stub / "__init__.py").write_text("")
        (root / "benchmark/metrics/planted.py").write_text(PLANTED)
        man["end_to_end"].append({"name": "planted", "unit": "count",
                                  "better": "lower", "bound": 0.25,
                                  "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import run\n"
        "from benchlib import manifest\n"
        "c = manifest.cell('tum640.detect_only.b16', run.ROOT)\n"
        "sys.exit(run.run_and_report(c, 2 ** 31 + 7, 0.5, False, 'cpu'))\n"
        % str(root / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(root))
    if planted:
        assert out.returncode == 5, out.stderr[-2000:]
        assert out.stdout.strip() == "" and "jax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "hessgpu_tpu_torch_extra",
                        types.ModuleType("hessgpu_tpu_torch_extra"))
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hessgpu_tpu.params",
                        types.ModuleType("hessgpu_tpu.params"))
    assert bench.forbidden_modules() == ["hessgpu_tpu"]


def test_run_py_refuses_without_a_card_and_without_the_program(tmp_path):
    """No card: exit 3 and no result line. A checkout of BENCHMARK.json and
    the benchmark alone: exit 4 (or 3 where there is no card)."""
    args = ["--workload", "tum640.describe.b16", "--seed", "5",
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    import torch
    if not torch.cuda.is_available():
        assert out.returncode == 3 and out.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(bare))
    assert out.returncode in (3, 4) and out.stdout.strip() == ""
    out = subprocess.run([sys.executable, "benchmark/run.py",
                          "--workload", "no.such", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=str(bare))
    assert out.returncode == 2 and out.stdout.strip() == ""
