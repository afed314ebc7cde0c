"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].
48L d_model=2048 32H (GQA kv=4, d_head=128) vocab=151936,
d_ff_expert=768."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_head=128, d_ff=768, vocab=151936, qk_norm=True,
    rope_theta=1e6, kind="moe",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, n_shared=0,
                  dispatch="vsn", capacity_factor=1.0),
    tie_embeddings=False, n_microbatches=8,
)
