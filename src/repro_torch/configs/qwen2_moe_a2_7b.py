"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 heads (MHA kv=16), 60 routed experts with
per-expert d_ff 1408, top-4 routing, plus 4 shared experts (merged here
into one shared SwiGLU of width 4x1408 = 5632, matching the released
shared_expert_intermediate_size), vocab 151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    num_experts=60, top_k=4, expert_d_ff=1408,
    num_shared_experts=4, shared_expert_d_ff=5632,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B config",
)
