"""host_launches_per_request (compiled layer, utils/graphs.py): the CUDA
runtime calls that put work on the device (kernel, graph, copy and fill
launches; a graph's replay is one) per request of the traced segment, from
the profiler's runtime events."""


def read(run):
    if run.trace is None or run.trace.requests == 0:
        return None
    if not run.trace.host_launches:       # no runtime calls in the trace
        return None
    return run.trace.host_launches / run.trace.requests
