"""hymba-1.5b [hybrid]: parallel attention + mamba heads
[arXiv:2411.13676].  32L d_model=1600 25H (GQA kv=5, d_head=64)
d_ff=5504 vocab=32001, ssm_state=16."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", n_layers=32, d_model=1600, n_heads=25,
    n_kv_heads=5, d_head=64, d_ff=5504, vocab=32001, kind="hybrid",
    ssm_state=16, ssm_heads=25, tie_embeddings=True, n_microbatches=8,
)
