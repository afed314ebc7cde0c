"""Model / run configuration for the assigned architecture zoo.

Held against ``src/repro/models/config.py``: a copy.  ``scan_layers``,
``remat``, ``n_microbatches`` and ``analysis_unroll`` are knobs of the
reference's jitted programs; the port's eager layer loop reads none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, deepseek-style
    dispatch: str = "vsn"        # "vsn" (all-gather+mask) | "sn" (all-to-all)
    capacity_factor: float = 1.25  # SN dispatch only


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None             # default d_model // n_heads
    kind: str = "dense"          # dense | moe | rwkv | hybrid
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # gemma3: (local_window, global_every): 5 local : 1 global
    window_pattern: Optional[Tuple[int, int]] = None
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0           # hymba mamba-head state size
    ssm_heads: int = 0           # hymba parallel mamba heads
    rwkv_head: int = 64          # rwkv6 head size
    tie_embeddings: bool = True
    frontend: str = "token"      # token | embedding_stub (vlm/audio backbones)
    norm_eps: float = 1e-6
    # --- runtime knobs (shared by train/serve) ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    n_microbatches: int = 1
    # roofline analysis mode: unroll the attention KV-chunk loop so XLA's
    # cost_analysis (which counts while-loop bodies once) sees every chunk
    analysis_unroll: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded so the vocab axis shards evenly (tp=16);
        labels never reference padding ids (hymba: 32001 -> 32016)."""
        return -(-self.vocab // 16) * 16

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameters (attention + ffn/moe + embeddings)."""
        d, f, l = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.n_heads:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.kind == "rwkv":
            per_layer += 6 * d * d + 2 * d * f  # time-mix + channel-mix
        elif self.kind == "hybrid":
            ssm_inner = self.ssm_heads * self.head_dim
            per_layer += 2 * d * ssm_inner + 2 * ssm_inner * self.ssm_state
            per_layer += 3 * d * f
        elif self.kind == "moe":
            m = self.moe
            per_layer += d * m.n_experts  # router
            per_layer += (m.n_experts + m.n_shared) * 3 * d * m.d_ff_expert
        else:
            per_layer += 3 * d * f
        return emb + l * per_layer + 2 * d * l  # + norms

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k + shared only)."""
        if self.kind != "moe":
            return self.param_count()
        d, l, m = self.d_model, self.n_layers, self.moe
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                     + d * m.n_experts
                     + (m.top_k + m.n_shared) * 3 * d * m.d_ff_expert)
        return emb + l * per_layer + 2 * d * l
