"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, ssm_state=128,
vocab=50280. SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free); kept for config uniformity
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    layout=("mamba",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
)
