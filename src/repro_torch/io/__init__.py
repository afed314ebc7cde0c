"""Sinks of the pipeline's outputs (port of ``src/repro/io``)."""
