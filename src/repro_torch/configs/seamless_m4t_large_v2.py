"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d_model=1024 16H d_ff=8192
vocab=256206.  [arXiv:2308.11596; hf]

Backbone only per the assignment: the speech frontend is a stub — the encoder
consumes precomputed frame embeddings from ``input_specs()``; the text decoder
cross-attends to the encoder memory.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,  # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    activation="relu",
    rope_theta=10_000.0,
)
