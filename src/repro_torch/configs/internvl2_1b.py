"""InternVL2-1B language backbone [arXiv:2404.16821].

InternViT-300M vision tower + Qwen2-0.5B LLM; per the assignment
carve-out the vision tower is stubbed (input_specs supplies 256 patch
embeddings) and this config is the Qwen2-0.5B-shaped decoder that
consumes them: 24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864,
vocab 151655, QKV bias (Qwen2 family trait).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, rope_theta=1e6,
    num_patches=256,
    source="arXiv:2404.16821 (InternVL2); LLM = Qwen2-0.5B shape",
)
