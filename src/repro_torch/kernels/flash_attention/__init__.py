"""Flash-attention kernel (port of ``src/repro/kernels/flash_attention``)."""
