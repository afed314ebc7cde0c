"""deepseek-moe-16b [moe]: fine-grained experts [arXiv:2401.06066].
28L d_model=2048 16H (kv=16) vocab=102400; 64 routed experts top-6 +
2 shared, d_ff_expert=1408."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=102400, kind="moe",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  dispatch="vsn"),
    tie_embeddings=False, n_microbatches=4,
)
