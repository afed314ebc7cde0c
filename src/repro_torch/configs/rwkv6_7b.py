"""rwkv6-7b "Finch" [ssm]: attention-free, data-dependent decay
[arXiv:2404.05892].  32L d_model=4096 d_ff=14336 vocab=65536,
head size 64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab=65536, kind="rwkv", rwkv_head=64,
    tie_embeddings=False, n_microbatches=8,
)
