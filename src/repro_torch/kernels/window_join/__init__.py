"""Window band-join kernel (port of ``src/repro/kernels/window_join``)."""
