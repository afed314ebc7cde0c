"""End-to-end metric readers: ``<name>.py`` holds ``read(run)``, the
metric from the host clock's stamps of the measured window."""
