"""The most staged super-batches waiting between the ingest thread and
the step loop in the window (``RunReport.queue_high_water``)."""


def read(run):
    return float(run.report.queue_high_water)
