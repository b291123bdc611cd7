"""kernel_roofline (kernels): the port's kernels' summed least time over
their summed device time in the traced segment, in percent of the card's
published peaks (benchmark/roofline/peaks.json, at 700 W). A kernel's least
time is, launch by launch, the larger of its bytes over the bandwidth and
its operations over the float32 rate, the work that the stages it does
(benchmark/roofline/<stage>.py) need for these inputs. A kernel of the
table that did not run, or has no count, adds nothing to either side."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib.trace import symbol  # noqa: E402


def read(run):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    spent = {}
    for n, v in t.by_kernel.items():
        sym = symbol(n)
        if sym in run.kernel_table:
            spent[sym] = spent.get(sym, 0.0) + v[0]
    used = [s for s in spent if run.kernel_least_s.get(s)]
    device = sum(spent[s] for s in used)
    if device <= 0:
        return None
    return 100.0 * sum(run.kernel_least_s[s] for s in used) / device
