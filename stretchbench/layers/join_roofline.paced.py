"""``join_roofline`` in the paced cell, where the latency is what it
moves."""

from stretchbench.layers.join_roofline import read  # noqa: F401
