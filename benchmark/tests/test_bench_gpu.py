"""On the card: each cell run once by its command with a short window, its
result line read back (marker gpu; skips without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_and_is_correct(card, cell, traced):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 1234), "--seconds", "2", "--trace", str(traced)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    if traced:
        assert result["device"]["busy_s"] > 0
        assert 0 < result["metrics"]["kernel_roofline"]["value"] <= 100
    else:
        assert set(result["metrics"]) == {"setup_s", "frames_per_s",
                                          "request_p95_ms"}
