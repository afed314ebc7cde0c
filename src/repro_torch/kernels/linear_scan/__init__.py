"""Linear-recurrence scan kernel (port of ``src/repro/kernels/linear_scan``)."""
