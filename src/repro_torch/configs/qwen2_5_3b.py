"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B; shape per assignment].

36L, d_model 2048, 16 heads (GQA kv=2), d_ff 11008, vocab 151936,
QKV bias (Qwen2.5 family trait).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5 family (bias QKV); assigned shape",
)
