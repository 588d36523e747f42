"""A ``mamba2`` configuration as the program's ssm ``ModelConfig``.  The
program's ssm family has no tied head; the configuration file states
``tie_embeddings`` false where it runs."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from perfbench.reference.mamba2 import vocab_rows


def port_config(cfg: dict) -> ModelConfig:
    if cfg["tie_embeddings"]:
        raise ValueError("the program's ssm family keeps a separate head: "
                         "a mamba2 configuration states tie_embeddings "
                         "false")
    if cfg["ngroups"] != 1:
        raise ValueError("the program's Mamba2 block has one group of B "
                         "and C")
    return ModelConfig(
        name=cfg["name"], family="ssm", num_layers=cfg["n_layer"],
        d_model=cfg["d_model"], num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=vocab_rows(cfg), ssm_state=cfg["d_state"],
        ssm_head_dim=cfg["headdim"], ssm_expand=cfg["expand"],
        ssm_conv=cfg["d_conv"], ssm_chunk=cfg["chunk_size"],
        norm_eps=float(cfg["norm_epsilon"]), source=cfg["source"])
