"""Architecture registry — port of ``repro/configs/registry.py``.

``--arch <id>`` → ModelConfig (+ reduced variants).

``get(name)`` returns the exact assigned config; ``reduced(name)`` shrinks the
same family shape (few layers / narrow width / tiny vocab / few experts) for
CPU smoke tests.  The port serves the full ``qwen2.5-3b`` on a card
(``chip_smoke.py``); the reference exercises full configs via its dry-run.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_MODULES = {
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_0_5b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "qwen2.5-3b": "repro_torch.configs.qwen25_3b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

ARCH_NAMES: tuple[str, ...] = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    import importlib

    try:
        mod = importlib.import_module(_MODULES[name])
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {ARCH_NAMES}") from None
    return mod.CONFIG


def reduced(name: str, **overrides) -> ModelConfig:
    """Same family, tiny dimensions — one forward/train step runs on CPU."""
    cfg = get(name)
    period = len(cfg.layout)
    changes: dict = dict(
        n_layers=2 * period,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 // cfg.group) if cfg.group > 1 else 4,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_prefix_embeds=min(cfg.n_prefix_embeds, 4),
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        dtype="float32",
        param_dtype="float32",
        attention_chunk=32,
        cache_b0=8,
        remat=False,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=128,
            capacity_b0=4,
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=8
        )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
