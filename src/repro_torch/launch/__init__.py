"""Command-line drivers of the port (port of ``src/repro/launch``)."""
