"""Per-layer metric readers: ``<name>.py`` holds ``read(run)``, the metric
from the traced run's record, or None where it finds nothing to read."""
