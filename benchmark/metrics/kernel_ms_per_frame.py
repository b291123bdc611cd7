"""kernel_ms_per_frame (kernels: csrc/conv.cu, detect.cu, patch.cu through
ops/cuda/*): device time per frame of the port's own kernels, those that
benchmark/roofline/kernels/ lists, in the traced segment."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib.trace import symbol  # noqa: E402


def read(run):
    t = run.trace
    if t is None or run.traced_frames == 0:
        return None
    s = sum(v[0] for n, v in t.by_kernel.items()
            if symbol(n) in run.kernel_table)
    if s <= 0:
        return None
    return s / run.traced_frames * 1e3
