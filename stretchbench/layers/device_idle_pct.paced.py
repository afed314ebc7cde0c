"""``device_idle_pct`` in the paced cell, where the latency is what it
moves."""

from stretchbench.layers.device_idle_pct import read  # noqa: F401
