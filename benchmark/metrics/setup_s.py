"""setup_s: process start to the first timed request (import, the kernels'
load or build, the frames made on the device, the graph capture of the
cell's shape, one pass over the ring). Host clock."""


def read(run):
    return run.setup_s
