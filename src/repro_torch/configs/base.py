"""Model/run configuration dataclasses — port of ``repro/configs/base.py``.

The dataclasses are the reference's, field for field, so a config compares
equal across the two packages (``tests/test_torch_configs.py``).  Knobs that
only shape the TPU program are kept as documented no-ops on the GPU:
``kernel_memory_space`` (the Pallas VMEM/HBM tiling), ``remat`` (JAX
rematerialisation; the port serves, it does not differentiate) and
``insertion_method``.

A ``ModelConfig`` describes one architecture from the assigned pool.  Layer
heterogeneity (Jamba's 1:7 Mamba:attention interleave, every-other-layer MoE)
is expressed as a repeating **period**: ``layout`` lists the layer kinds of one
period and the stack scans ``n_layers // len(layout)`` periods — keeping the
lowered HLO O(one period) regardless of depth (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

LayerKind = Literal["attn", "mamba"]
AttentionImpl = Literal["blockwise", "blockwise_tri", "xla", "pallas"]
CachePolicy = Literal["static", "semistatic", "ggarray", "two_phase", "paged"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Which layers in the period run MoE MLPs (indices into layout).
    moe_period: int = 1  # every `moe_period`-th layer is MoE
    moe_offset: int = 0
    # GGArray-style growable expert buffers: capacity snaps to geometric
    # bucket levels instead of dropping at a fixed factor (DESIGN.md §3).
    ggarray_capacity: bool = False
    capacity_b0: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None  # default d_model // n_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    # layer heterogeneity: one period of layer kinds; dense = ("attn",)
    layout: tuple[LayerKind, ...] = ("attn",)
    # sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # encoder-decoder (seamless): encoder layers + cross-attention decoder
    n_enc_layers: int = 0
    # multimodal stub frontend: number of prefix embeddings provided by
    # input_specs() (ViT patches / audio frames), 0 = text-only
    n_prefix_embeds: int = 0
    # MLP activation
    activation: Literal["swiglu", "gelu", "relu"] = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "bfloat16"
    # implementation switches
    attention_impl: AttentionImpl = "blockwise"
    attention_chunk: int = 1024  # KV chunk for blockwise attention
    cache_policy: CachePolicy = "ggarray"
    cache_b0: int = 2048  # first KV bucket length (GGArray B0 for the cache)
    cache_quant: bool = False  # int8 KV cache (per-token/head scales) — §Perf
    # paged policy (slab arena, DESIGN.md §4): tokens per slab (0 → cache_b0;
    # equality with cache_b0 is what makes the paged level walk bit-exact vs
    # the ggarray bucket walk) and the attend implementation behind it
    cache_slab: int = 0
    paged_attend_impl: Literal["levels", "pallas"] = "levels"
    # memory space for the indirection kernels (paged / push_back / flatten):
    # None = auto (hbm on TPU, vmem in interpret mode — kernels/common).
    # A TPU tiling: checked, and without effect on the GPU kernels.
    kernel_memory_space: Literal["vmem", "hbm"] | None = None
    insertion_method: str = "scan"
    remat: bool = True
    # device counter plane (obs/device, DESIGN.md §9.x): when set, the cache
    # ops record in-kernel/jnp counters and the step functions return an
    # extra counter vector.  Off by default — the uninstrumented trace is
    # byte-identical to a config without the field (compile-spy tested).
    instrument: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.layout):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period {len(self.layout)}"
            )
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must divide by n_kv_heads")

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the table TP-shards cleanly (16 | 256);
        out-of-vocab logit columns are masked to -inf before any softmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layout)

    @property
    def slab_tokens(self) -> int:
        """Tokens per KV slab under the paged cache policy."""
        return self.cache_slab or self.cache_b0

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def is_moe_layer(self, idx_in_period: int) -> bool:
        if self.moe is None:
            return False
        return idx_in_period % self.moe.moe_period == self.moe.moe_offset

    # -- parameter counting (for roofline MODEL_FLOPS) --------------------
    def param_counts(self) -> dict[str, float]:
        """Total and active parameter counts (active ≙ per-token compute)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        if self.qkv_bias:
            attn += dh * (self.n_heads + 2 * self.n_kv_heads)
        dense_mlp = (
            3 * d * self.d_ff if self.activation == "swiglu" else 2 * d * self.d_ff
        )
        mamba = 0.0
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            g, n = self.ssm.n_groups, self.ssm.d_state
            nh = self.ssm.n_ssm_heads(d)
            in_proj = d * (2 * di + 2 * g * n + nh)
            mamba = in_proj + (di + 2 * g * n) * self.ssm.d_conv + di * d + di + 2 * nh

        total = 0.0
        active = 0.0
        for i, kind in enumerate(self.layout):
            if kind == "mamba":
                total += mamba
                active += mamba
                continue
            total += attn
            active += attn
            if self.is_moe_layer(i):
                e_mlp = 3 * d * self.moe.d_ff_expert
                total += self.moe.n_experts * e_mlp + d * self.moe.n_experts
                active += self.moe.top_k * e_mlp + d * self.moe.n_experts
            else:
                total += dense_mlp
                active += dense_mlp
        total *= self.n_periods
        active *= self.n_periods
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = 0.0
        if self.n_enc_layers:
            enc = self.n_enc_layers * (attn + dense_mlp)
            # decoder cross-attention blocks
            total += self.n_layers * attn
            active += self.n_layers * attn
        total += embed + enc
        active += embed + enc
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def sub_quadratic_ready(cfg: ModelConfig) -> bool:
    """True if the arch can run long_500k (SSM/hybrid; not pure full attention)."""
    return any(kind == "mamba" for kind in cfg.layout)
