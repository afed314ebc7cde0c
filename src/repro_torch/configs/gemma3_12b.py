"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8, d_head=256)
d_ff=15360 vocab=262144; 5:1 local:global sliding attention (window 1024),
128k context [hf:google/gemma-3-12b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
    n_kv_heads=8, d_head=256, d_ff=15360, vocab=262144, qk_norm=True,
    window_pattern=(1024, 6), kind="dense", tie_embeddings=True,
    n_microbatches=8,
)
