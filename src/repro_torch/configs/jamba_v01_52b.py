"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attention 1:7 interleave. [arXiv:2403.19887; hf]

Period of 8 layers: slots 0-3 mamba, slot 4 attention (offset 4 per the Jamba
paper), slots 5-7 mamba; MoE on every second layer (offset 1).  Jamba's
Mamba-1 blocks are realized with the SSD layer (d_state=16) — see DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layout=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, moe_period=2, moe_offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    activation="swiglu",
    rope_theta=10_000.0,
)
