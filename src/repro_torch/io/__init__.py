"""Live-stream I/O (port of ``src/repro/io``): sources, bounded queues,
sinks and the metrics bus."""

from repro_torch.io.metrics import MetricsBus
from repro_torch.io.queues import TIMEOUT, BoundedQueue, QueueClosed
from repro_torch.io.sinks import CollectSink, NullSink
from repro_torch.io.sources import (RateSchedule, ReplaySource,
                                    SyntheticSource, load_stream, save_stream)

__all__ = [
    "BoundedQueue", "CollectSink", "MetricsBus", "NullSink", "QueueClosed",
    "RateSchedule", "ReplaySource", "SyntheticSource", "TIMEOUT",
    "load_stream", "save_stream",
]
