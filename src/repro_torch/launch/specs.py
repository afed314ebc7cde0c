"""Sharding rules per architecture and the PartitionSpec trees of the
parameters, optimizer state and caches.

Held against ``src/repro/launch/specs.py``.  The logical->mesh rules
adapt to the arch: attention heads shard over "model" only when the KV
head count divides the TP degree (musicgen, deepseek-moe); otherwise head
axes stay unconstrained for compute and the *KV cache timeline* carries
the model axis ("kv_seq"), so decode state fits memory with only
scalar-sized softmax collectives.

The spec trees follow the port's parameter tree (``transformer.
init_params``: ``layers`` a list of per-layer dicts, no leading layer
axis).  ``param_specs(cfg, stacked=True)`` gives the reference's layout
instead (a leading ``None`` on every layer leaf under ``scan_layers``),
which ``convert.to_reference`` maps the parameters to; ``opt_specs``,
``fit_spec`` and ``fit_tree`` take either.  ZeRO-1 over per-layer leaves
shards each moment on its own first free dimension, where the
reference's stacked leaves may shard the layer axis: the bytes a device
holds are the same whenever that dimension divides.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import DEFAULT_RULES, P


def map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a spec tree (dicts, lists, NamedTuples;
    a ``P`` or None is a leaf) and trees of its structure."""
    if specs is None or isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    items = [map_specs(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(specs)]
    return type(specs)(*items) if hasattr(specs, "_fields") else \
        type(specs)(items)


def make_rules(cfg: ModelConfig, tp: int = 16) -> dict:
    rules = dict(DEFAULT_RULES)
    heads_ok = cfg.n_heads and cfg.n_kv_heads % tp == 0 \
        and cfg.n_heads % tp == 0
    if heads_ok:
        rules["heads"] = "model"
        rules["kv_heads"] = "model"
        rules["head_dim"] = None
        rules["kv_seq"] = None
    else:
        rules["heads"] = None
        rules["kv_heads"] = None
        rules["head_dim"] = None
        rules["kv_seq"] = "model"       # decode cache: shard the timeline
    return rules


def _layer_specs(cfg: ModelConfig, prefix=()):
    """PartitionSpec tree matching init_layer's dict structure."""
    pre = prefix

    def p(*axes):
        return P(*(pre + axes))

    d: dict = {"norm1": p(None), "norm2": p(None)}
    if cfg.kind == "rwkv":
        d["tm"] = {
            "mu_r": p(None), "mu_k": p(None), "mu_v": p(None),
            "mu_w": p(None), "mu_g": p(None),
            "w_r": p(None, "model"), "w_k": p(None, "model"),
            "w_v": p(None, "model"), "w_g": p(None, "model"),
            "w_o": p("model", None),
            "w0": p(None), "w_lora_a": p(None, None),
            "w_lora_b": p(None, None), "u": p(None), "ln_scale": p(None),
        }
        d["cm"] = {
            "mu_k": p(None), "mu_r": p(None),
            "w_k": p(None, "model"), "w_v": p("model", None),
            "w_r": p(None, "model"),
        }
        return d
    d["attn"] = {
        "wq": p(None, "model"), "wk": p(None, "model"),
        "wv": p(None, "model"), "wo": p("model", None),
    }
    if cfg.qk_norm:
        d["attn"]["q_scale"] = p(None)
        d["attn"]["k_scale"] = p(None)
    if cfg.kind == "hybrid":
        d["norm1b"] = p(None)
        d["ssm"] = {
            "w_x": p(None, "model"), "w_z": p(None, "model"),
            "w_b": p(None, "model"), "w_c": p(None, "model"),
            "w_dt": p(None, None), "w_out": p("model", None),
            "a_log": p(None),
        }
    if cfg.kind == "moe":
        d["moe"] = {
            "router": p(None, None),
            "wg": p("model", None, None), "wu": p("model", None, None),
            "wd": p("model", None, None),
        }
        if cfg.moe.n_shared:
            d["moe"]["shared_wg"] = p(None, "model")
            d["moe"]["shared_wu"] = p(None, "model")
            d["moe"]["shared_wd"] = p("model", None)
    else:
        d["mlp"] = {"wg": p(None, "model"), "wu": p(None, "model"),
                    "wd": p("model", None)}
    return d


def param_specs(cfg: ModelConfig, stacked: bool = False):
    """The parameters' specs: the port's tree, or with ``stacked`` the
    reference's (layers stacked under ``scan_layers``)."""
    specs = {
        "embedding": P("model", None),     # vocab-sharded
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P("model", None)
    if stacked and cfg.scan_layers:
        specs["layers"] = _layer_specs(cfg, (None,))
    else:
        specs["layers"] = [_layer_specs(cfg) for _ in range(cfg.n_layers)]
    return specs


def opt_specs(abstract_params, pspecs, data_size: int = 16,
              dp_axes=("data",)):
    """ZeRO-1: each f32 moment additionally shards over the data axis on the
    first dim that is (a) unsharded in the param spec and (b) divisible by
    the DP degree.  The dry-run's collectives then show the gather and
    scatter around the optimizer update."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def zero1(spec: P, leaf):
        shape = leaf.shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, ax) in enumerate(zip(shape, entries)):
            if ax is None and dim % data_size == 0 and dim >= data_size:
                entries[i] = dp
                break
        return P(*entries)

    return map_specs(zero1, pspecs, abstract_params)


def fit_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes that don't exist or don't divide the dim (batch=1
    decode, odd vocab, pod axis on a single-pod mesh, ...)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in mesh.shape)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if axes and size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return P(*out)


def fit_tree(specs, abstract, mesh):
    return map_specs(lambda sp, ab: fit_spec(sp, ab.shape, mesh), specs,
                     abstract)


def cache_specs(cfg: ModelConfig, rules: dict):
    """KV caches [L, B, S, KV, Dh] / recurrent states."""
    dp = rules["batch"]
    if cfg.kind == "rwkv":
        state = rules["state"]
        return None, {
            "shift_tm": P(None, dp, None),
            "shift_cm": P(None, dp, None),
            "wkv": P(None, dp, state, None, None),
        }
    kv_seq = rules["kv_seq"]
    kv_heads = rules["kv_heads"]
    caches = {"k": P(None, dp, kv_seq, kv_heads, None),
              "v": P(None, dp, kv_seq, kv_heads, None)}
    states = None
    if cfg.kind == "hybrid":
        states = P(None, dp, None, None, None)
    return caches, states
