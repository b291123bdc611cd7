"""enqueue_ms (entry layer, parallel/batch.py detect_batch): the host's
time in detect_batch per request, up to its return, averaged over every
request of the measured window (the benchmark's own span; host clock)."""


def read(run):
    if not run.enqueue_s:
        return None
    return sum(run.enqueue_s) / len(run.enqueue_s) * 1e3
