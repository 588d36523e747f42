"""MusicGen-large decoder [arXiv:2306.05284].

Decoder-only transformer over 4 parallel EnCodec codebooks (vocab 2048
each): 48L, d_model 2048, 32 heads (MHA), d_ff 8192.  The EnCodec
tokenizer and T5 text conditioner are stubbed; conditioning enters as
64 precomputed frames prepended to the sequence (prepend mode; the
released cross-attention variant is noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    num_codebooks=4, cond_len=64,
    source="arXiv:2306.05284 (MusicGen large)",
)
