"""ScaleGate merge kernel (port of ``src/repro/kernels/scalegate_merge``)."""
