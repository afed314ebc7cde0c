"""The VSN pipeline's core (port of ``src/repro/core``)."""
