"""Optimizers of the training path (port of ``src/repro/optim``)."""
