"""A ``qwen2`` configuration (Qwen2 / Qwen2.5 ``config.json`` keys) as the
program's dense ``ModelConfig``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def port_config(cfg: dict) -> ModelConfig:
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        qkv_bias=True, rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        source=cfg["source"])
