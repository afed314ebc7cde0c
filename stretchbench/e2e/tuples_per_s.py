"""Input tuples of the super-batches whose results reached the sink inside
the window, over the window's seconds."""


def read(run):
    done = [sb for sb, t in run.sink_accepted.items()
            if run.t0 <= t <= run.t_end]
    return float(sum(run.sb_tuples[sb] for sb in done) / run.seconds)
