"""Live-stream I/O (port of ``src/repro/io``): sources, bounded queues,
sinks and the metrics bus."""
