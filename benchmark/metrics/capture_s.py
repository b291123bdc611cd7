"""capture_s (compiled layer, utils/graphs.py): the seconds the cell's
graph captures took (the eager warm-up call, the capture, instantiation),
GraphStats.capture_s summed by the pipeline's GraphCache."""


def read(run):
    c = run.counters.get("capture_s")
    if not run.counters.get("captures"):
        return None
    return c
