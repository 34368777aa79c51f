"""Dense MLP blocks — port of ``repro/models/mlp.py``: SwiGLU (llama/qwen
lineage), GELU (starcoder2, tanh approximation as ``jax.nn.gelu``), ReLU.
The products are plain ``torch.matmul``, as the reference leaves them to
XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import Param, dense_init

__all__ = ["init_mlp", "mlp_block"]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype, *, lead: tuple[int, ...] = ()) -> Param:
    """``lead``: leading stacking dims (the period axis of a layer stack)."""
    def w(shape, fan_in):
        return dense_init(gen, shape, dtype, fan_in, lead=lead)

    dev = gen.device
    if activation == "swiglu":
        return {
            "w_gate": w((d_model, d_ff), d_model),
            "w_up": w((d_model, d_ff), d_model),
            "w_down": w((d_ff, d_model), d_ff),
        }
    return {
        "w_up": w((d_model, d_ff), d_model),
        "b_up": torch.zeros((*lead, d_ff), dtype=dtype, device=dev),
        "w_down": w((d_ff, d_model), d_ff),
        "b_down": torch.zeros((*lead, d_model), dtype=dtype, device=dev),
    }


def mlp_block(p: Param, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if activation == "gelu":
        h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    else:
        h = F.relu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]
