"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]

Treated as full attention (iRoPE chunked-attention variants out of scope →
long_500k skipped, DESIGN.md §6).  Early fusion is realized as the multimodal
prefix-embedding path (stub frontend).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192),
    activation="swiglu",
    rope_theta=500_000.0,
)
