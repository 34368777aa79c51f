"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

InternViT frontend is a stub (``input_specs()`` provides 256 patch
embeddings); the InternLM2-style decoder is the real backbone.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_prefix_embeds=256,
    activation="swiglu",
    rope_theta=1_000_000.0,
)
