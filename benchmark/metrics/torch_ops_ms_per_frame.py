"""torch_ops_ms_per_frame (tensor code: ops/compaction.py, the table and
expansion of pyramid.py, ops/descriptor.finalize_descriptors, the graph's
copies in and out): device time per frame of every device operation that
is not one of the port's own kernels (benchmark/roofline/kernels/), in the
traced segment."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib.trace import symbol  # noqa: E402


def read(run):
    t = run.trace
    if t is None or not t.by_kernel or run.traced_frames == 0:
        return None
    s = sum(v[0] for n, v in t.by_kernel.items()
            if symbol(n) not in run.kernel_table)
    return s / run.traced_frames * 1e3
