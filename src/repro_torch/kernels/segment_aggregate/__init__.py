"""Segment-aggregate kernel (port of ``src/repro/kernels/segment_aggregate``)."""
