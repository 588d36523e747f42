"""Mamba2-1.3B [arXiv:2405.21060].

Attention-free SSD: 48 layers, d_model 2048, ssm_state 128, head dim 64
(expand 2 -> 64 SSD heads), vocab 50280.  long_500k decode runs natively
(constant-size state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    source="arXiv:2405.21060 (Mamba2-1.3B)",
)
