"""Llama-3.1 8B [arXiv:2407.21783].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128, rope_theta=5e5,
    source="arXiv:2407.21783 Table 3",
)
