"""Llama-4 Scout 17B-active / 16-expert [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE with 16 routed experts, top-1 routing, plus one shared expert
(model-card architecture); early-fusion multimodality is out of scope —
the text decoder is what is assigned.  48L, d_model 5120, 40 heads
(GQA kv=8), expert d_ff 8192, vocab 202048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128, rope_theta=5e5,
    num_experts=16, top_k=1, expert_d_ff=8192,
    num_shared_experts=1, shared_expert_d_ff=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E model card",
)
