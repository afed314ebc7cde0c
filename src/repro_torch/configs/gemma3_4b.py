"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4, d_head=256)
d_ff=10240 vocab=262144; 5:1 local:global (window 1024)
[hf:google/gemma-3-4b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8,
    n_kv_heads=4, d_head=256, d_ff=10240, vocab=262144, qk_norm=True,
    window_pattern=(1024, 6), kind="dense", tie_embeddings=True,
    n_microbatches=4,
)
