"""musicgen-large [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284].  48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend (4 codebooks, delay pattern) is a stub per the
assignment: input_specs() provides precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=2048, kind="dense",
    frontend="embedding_stub", tie_embeddings=True, n_microbatches=4,
)
