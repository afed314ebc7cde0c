"""What the roofline readers share: a traced window's device time of the
kernels whose name holds a symbol, and their count."""

MERGE = "scalegate_"


def time_and_count(run, match):
    if run.trace is None:
        return 0.0, 0
    t, n = 0.0, 0
    for name, a, b in run.trace["kernels"]:
        if match(name):
            t += (b - a) / 1e9
            n += 1
    return t, n


def is_copy(name):
    return name.startswith(("Memcpy", "Memset"))
