"""Zamba2-1.2B [arXiv:2411.15242].

38 Mamba2 layers (d_model 2048, ssm_state 64) with ONE shared
attention+MLP block (32 heads, d_ff 8192) applied every 6 SSM layers,
weights shared across applications.  Vocab 32000.  Simplifications vs
the release (concat-input to the shared block, per-site LoRA) are noted
in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6,
    source="arXiv:2411.15242 (Zamba2-1.2B)",
)
