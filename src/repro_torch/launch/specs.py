"""Dry-run cell plan and step builders — port of ``repro/launch/specs.py``.

``plan_cells()`` enumerates the 40 (arch × shape) cells with their skip
reasons; ``build_cell()`` returns a step function, its arguments and the
options the dry-run applies to it.  The arguments are ``DTensor``s of the
reference's global shapes and dtypes, laid out by ``param_specs``,
``batch_specs`` and ``cache_specs`` — the reference's ``jax.eval_shape`` +
``NamedSharding``.  Build them under ``FakeTensorMode`` (as the dry-run
does) and nothing is allocated: each rank's shard is a fake tensor of the
local shape on the card's device type, made with ``DTensor.from_local``
(``distribute_tensor`` would need the whole tensor first).

Where the reference hands ``jit`` its options, the port returns them as a
dict (``build_cell``'s third value) that the dry-run applies:
- ``"donate"``: the argument indices whose buffers the step may update in
  place (the train state; the decode caches), so the bytes it writes back
  into them count as aliased;
- ``"out_specs"``: prefill's output layout — logits ``P(data, "model")``
  and the caches by ``cache_specs``.

``input_specs`` builds the arguments from shapes alone: the reference runs
``jax.eval_shape`` over the whole prefill to learn the caches' shapes
(``specs.py:101``), and a Python-looped prefill of 32k tokens traced on
fake tensors is far slower than an abstract scan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, sub_quadratic_ready
from repro_torch.data.synthetic import batch_spec
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import PartitionSpec as P
from repro_torch.distributed.context import mesh_axes, placed_zeros
from repro_torch.models import encdec, transformer
from repro_torch.optim import adamw
from repro_torch.serving import steps as serve_steps
from repro_torch.train import step as train_mod
from repro_torch.tree import leaves, tree_map

__all__ = ["Cell", "plan_cells", "input_specs", "build_cell", "TRAIN_MICROBATCHES"]


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    skip_reason: str | None = None

    @property
    def name(self) -> str:
        return f"{self.arch}×{self.shape}"


def plan_cells() -> list[Cell]:
    cells = []
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch)
        for shape_name, shape in SHAPES.items():
            skip = None
            if shape_name == "long_500k" and not sub_quadratic_ready(cfg):
                skip = "pure full attention: 500k decode needs sub-quadratic (DESIGN.md §6)"
            cells.append(Cell(arch, shape_name, skip))
    return cells


def _placed(tree, specs, mesh, device):
    """Zero ``DTensor``s of ``tree``'s leaves' shapes and dtypes, laid out by
    ``specs`` on ``mesh``: each rank's shard only (fake under ``FakeTensorMode``)."""
    return tree_map(lambda t, spec: placed_zeros(tuple(t.shape), t.dtype, device, mesh, spec),
                    tree, specs)


def _param_shapes(cfg: ModelConfig):
    """The parameter tree's shapes and dtypes, as fake tensors: nothing
    drawn, nothing allocated (under the caller's ``FakeTensorMode``, or one
    of its own)."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    active = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    with contextlib.nullcontext() if active is not None else FakeTensorMode():
        return transformer.init_params(cfg, torch.Generator())


def _decode_length_hint(cfg: ModelConfig, shape: ShapeConfig) -> int:
    # serve_step: one new token with a cache of seq_len ⇒ capacity covers
    # seq_len + 1 under the active policy.
    return shape.seq_len + 1


def input_specs(arch: str, shape_name: str, mesh, *, opt: bool = False, device="cuda") -> tuple:
    """Stand-ins for every model input of one cell: ``DTensor``s of the
    global shapes and dtypes, laid out on ``mesh``."""
    _, args, _ = build_cell(Cell(arch, shape_name), mesh, opt=opt, device=device)
    return args


def build_cell(cell: Cell, mesh, *, opt: bool = False, device="cuda") -> tuple[Callable, tuple, dict]:
    """→ (step_fn, placed arguments, options) — see the module docstring.

    ``opt=True`` applies the reference's hill-climb variants: triangular
    causal attention with 2048-token chunks (prefill, train), the int8 KV
    cache (decode), two microbatches (train)."""
    cfg = configs.get(cell.arch)
    shape = SHAPES[cell.shape]
    microbatches = None
    if opt:
        if shape.kind == "decode":
            cfg = dataclasses.replace(cfg, cache_quant=True)
        else:
            cfg = dataclasses.replace(cfg, attention_impl="blockwise_tri", attention_chunk=2048)
        if shape.kind == "train":
            microbatches = 2
    if shape.kind == "train":
        fn, args = _build_train(cfg, shape, mesh, device, microbatches=microbatches)
        return fn, args, {"donate": (0,)}
    if shape.kind == "prefill":
        fn, args = _build_prefill(cfg, shape, mesh, device)
        enc_len = shape.seq_len if cfg.n_enc_layers else None
        caches = serve_steps.init_decode_caches(cfg, shape.global_batch, shape.seq_len, enc_len=enc_len,
                                                device="meta")
        logits_spec = P(sh.data_axes(mesh) or None, "model")
        return fn, args, {"out_specs": (logits_spec, sh.cache_specs(caches, cfg, mesh))}
    fn, args = _build_decode(cfg, shape, mesh, device)
    return fn, args, {"donate": (2,)}


# --------------------------------------------------------------------------

TRAIN_MICROBATCHES = 8  # gradient accumulation: global 256 → 8 × 32-seq
# microbatches; the standard memory/throughput trade at this batch size and
# the overlap point for grad-reduction/backward (train/step.py).


def _batch(cfg: ModelConfig, shape: ShapeConfig, mesh, device) -> dict:
    bs = batch_spec(cfg, shape.global_batch, shape.seq_len)
    specs = sh.batch_specs(cfg, mesh, shape.global_batch)
    return {k: placed_zeros(s.shape, s.dtype, device, mesh, specs[k]) for k, s in bs.items()}


def _build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, device, microbatches: int | None = None):
    microbatches = TRAIN_MICROBATCHES if microbatches is None else microbatches
    opt_cfg = adamw.AdamWConfig()
    like = _param_shapes(cfg)
    pspecs = sh.param_specs(like, cfg, mesh)
    params = _placed(like, pspecs, mesh, device)
    for p in leaves(params):
        p.requires_grad_(True)
    f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"), like)
    state = train_mod.TrainState(
        params=params,
        opt=adamw.AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),  # as adamw.init
                             m=_placed(f32, pspecs, mesh, device), v=_placed(f32, pspecs, mesh, device)),
        ef=None)
    batch = _batch(cfg, shape, mesh, device)
    lr = torch.zeros((), dtype=torch.float32, device=device)  # a scalar every rank holds, as the step

    def step(state, batch, lr_scale):
        new_state, metrics = train_mod.train_step(
            state, batch, cfg, opt_cfg, lr_scale,
            microbatches=microbatches, grad_specs=pspecs,
        )
        return new_state, metrics["loss"]

    return step, (state, batch, lr)


def _build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, device):
    batch = _batch(cfg, shape, mesh, device)
    like = _param_shapes(cfg)
    params = _placed(like, sh.param_specs(like, cfg, mesh), mesh, device)

    def step(params, batch):
        kw: dict[str, Any] = {}
        if cfg.n_enc_layers:
            kw["memory"] = encdec.encode(params["encoder"], batch["frames"], cfg)
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        return serve_steps.prefill(params, batch["tokens"], cfg, capacity_hint=shape.seq_len, **kw)

    return step, (params, batch)


def _build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, device):
    B = shape.global_batch
    hint = _decode_length_hint(cfg, shape)
    like = _param_shapes(cfg)
    params = _placed(like, sh.param_specs(like, cfg, mesh), mesh, device)
    enc_len = shape.seq_len if cfg.n_enc_layers else None
    caches = serve_steps.init_decode_caches(cfg, B, hint, enc_len=enc_len, device=device, mesh=mesh)
    dp = sh.data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh_axes(mesh)[a]
    b_axis = dp if dp and B % dp_size == 0 else None
    token = placed_zeros((B,), torch.int32, device, mesh, P(b_axis))
    length = placed_zeros((), torch.int32, device, mesh, P())

    def step(params, token, caches, length):
        return serve_steps.decode_step(params, token, caches, length, cfg)

    return step, (params, token, caches, length)
