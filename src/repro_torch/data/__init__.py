"""Synthetic workloads (port of ``src/repro/data``)."""
