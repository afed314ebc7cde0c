"""chameleon-34b [vlm]: early-fusion VQ-token backbone [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  The modality
frontend (VQ image tokenizer) is a stub per the assignment: input_specs()
provides precomputed patch/token embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", n_layers=48, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
    kind="dense", frontend="embedding_stub", tie_embeddings=True,
    n_microbatches=16,
)
