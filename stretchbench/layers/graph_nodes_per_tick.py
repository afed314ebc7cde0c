"""Nodes of the super-batch's CUDA graph (``persistent_graphs()``) over
its K ticks."""


def read(run):
    for g in run.graphs.values():
        if g.get("nodes"):
            return float(g["nodes"]["nodes"] / run.k)
    return None
