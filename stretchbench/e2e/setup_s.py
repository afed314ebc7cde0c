"""From the start of the process to the start of the window: imports, the
kernels' build or load, the stream drawn from the seed, the pipeline and
its state, set-up's super-batches (the graph's capture) and, in a closed
loop, the settle under full load that precedes the window."""


def read(run):
    return float(run.setup_s)
