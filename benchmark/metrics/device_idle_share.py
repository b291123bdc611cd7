"""device_idle_share (device): 1 - busy / wall per request, in percent.
Busy is the device's work per request in the traced segment (the union of
its kernels, copies and fills on the profiler's timeline); wall is the time
per request of the measured window, untraced. The traced segment's own wall
(the `device` window_s) is longer: tracing a graph's launch costs the host
some 0.5-1 ms a request, which the untraced window does not pay."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.requests == 0 or run.requests == 0:
        return None
    busy = t.busy_s / t.requests
    wall = run.window_s / run.requests
    return 100.0 * (1.0 - busy / wall)
