"""Loss + train step: next-token CE, gradient accumulation, AdamW,
compression — port of ``repro/train/step.py``.

The reference differentiates with ``jax.value_and_grad`` and accumulates
microbatches in a ``lax.scan``; the port takes ``torch.autograd.grad`` of
the same loss (through ``models/modules.rms_norm``'s hand-written VJP and,
in MoE layers, routing ranks from K1 or K2, which carry no gradient) and
loops over the microbatches.  AdamW and the error-feedback compression
update the state in place (``optim/``), so ``train_step`` returns the
same parameter tensors it was given, updated.  A step makes no host
sync: the metrics stay on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed.context import (constrain_tree, is_dtensor, local_region, rank_index,
                                             reduce_partial, replicate_dims)
from repro_torch.models import encdec, transformer
from repro_torch.optim import adamw, compression
from repro_torch.tree import leaves, unflatten

__all__ = ["TrainState", "init_train_state", "loss_fn", "train_step", "make_train_step",
           "AUX_LOSS_WEIGHT"]

AUX_LOSS_WEIGHT = 0.01


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    ef: compression.EFState | None  # error feedback (grad compression)


def init_train_state(
    seed: int,
    cfg: ModelConfig,
    *,
    grad_compression: bool = False,
    device: "str | torch.device | None" = None,
) -> TrainState:
    """Random parameters from ``seed`` (requiring grad), zero moments and,
    with ``grad_compression``, a zero residual, on ``device`` (the card
    unless ``device="cpu"``)."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(seed)
    params = transformer.init_params(cfg, gen)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(
        params=params,
        opt=adamw.init(params),
        ef=compression.ef_init(params) if grad_compression else None,
    )


def _vocab_sharded(logits: torch.Tensor) -> bool:
    return is_dtensor(logits) and any(p.is_shard(logits.ndim - 1) for p in logits.placements)


class _VocabLSE(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of one rank's vocab slice of
    ``logits``, the slices' maxima and sums reduced over ``groups`` (the
    process groups of the mesh dims that split the vocab); its backward is
    ``torch.logsumexp``'s, ``g · exp(logits − lse)``, on the slice alone."""

    @staticmethod
    def forward(ctx, lg, groups):
        import torch.distributed as dist

        m = torch.amax(lg, dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        s = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        for g in groups:
            dist.all_reduce(s, group=g)
        lse = torch.log(s) + m
        ctx.save_for_backward(lg, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        lg, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(lg - lse[..., None]), None


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the vocab.  On a mesh that shards the vocab,
    each rank reduces its own slice in a ``local_map`` region and the
    slices' maxima and sums are reduced across the vocab's ranks
    (``_VocabLSE``); the gradient is each rank's slice, computed where it
    lies.  DTensor's ``logsumexp`` would gather the whole rows on every
    rank, and its backward of the same sum in DTensor ops regathers the
    vocab (rank 0 held three f32 copies of a microbatch's whole logits in
    the dry-run's ``train_4k`` cells: 19.9 GB each at qwen2.5-3b's vocab
    under ``--opt``)."""
    if not _vocab_sharded(logits):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Replicate

    vdim = logits.ndim - 1
    mesh = logits.device_mesh
    lp = list(logits.placements)
    groups = [mesh.get_group(d) for d, p in enumerate(lp) if p.is_shard(vdim)]
    out = [Replicate() if p.is_shard(vdim) else p for p in lp]
    return local_region(lambda lg: _VocabLSE.apply(lg, groups), mesh, (lp,), out)(logits)


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]``.  On a mesh that shards the vocab, each rank
    gathers from its own slice in a ``local_map`` region (a target outside
    the slice counts 0) and the slices' sums are reduced: no rank holds a
    whole row.  DTensor's own gather on a sharded dim fails, and gathering
    from the replicated rows would give every rank the whole logits in the
    backward (80 GB a rank in the dry-run's ``train_4k`` cells).  The
    result is laid out as ``_logsumexp``'s."""
    vdim = logits.ndim - 1
    if not _vocab_sharded(logits):
        return torch.gather(replicate_dims(logits, -1), -1, targets[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate

    mesh = logits.device_mesh
    width = logits.to_local().shape[-1]
    first = rank_index(mesh, [d for d, p in enumerate(logits.placements) if p.is_shard(vdim)]) * width

    def block(lg: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = t.long() - first
        ok = (t >= 0) & (t < lg.shape[-1])
        return torch.where(ok, torch.gather(lg, -1, torch.where(ok, t, 0)[..., None])[..., 0], 0.0)

    lp = list(logits.placements)
    whole = [Replicate() if p.is_shard(vdim) else p for p in lp]
    run = local_region(block, mesh, (lp, whole), [Partial() if p.is_shard(vdim) else p for p in lp])
    return reduce_partial(run(logits, targets))  # one slice holds each target


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (B, S, V) f32, targets (B, S).

    ``mask``: optional (B, S) loss mask (padding from the packing pipeline);
    the denominator is at least 1."""
    nll = _logsumexp(logits) - _gold(logits, targets)
    if mask is None:
        return reduce_partial(torch.mean(nll))
    mask = mask.to(nll.dtype)
    return reduce_partial(torch.sum(nll * mask)) / torch.clamp(reduce_partial(torch.sum(mask)), min=1.0)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """→ (CE + AUX_LOSS_WEIGHT · aux, {"ce", "aux"}).  Only token positions
    predict the next token: prefix embeddings are inputs."""
    tokens = batch["tokens"]
    memory = None
    if cfg.n_enc_layers:
        memory = encdec.encode(params["encoder"], batch["frames"], cfg)
    logits, aux = transformer.forward(
        params, tokens, cfg, prefix_embeds=batch.get("prefix_embeds"), memory=memory,
    )
    P = logits.shape[1] - tokens.shape[1]
    mask = batch.get("loss_mask")
    ce = _ce_loss(logits[:, P:-1], tokens[:, 1:], None if mask is None else mask[:, 1:])
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def _value_and_grad(params: dict, batch: dict, cfg: ModelConfig):
    """(loss, metrics) detached, and the gradient of every leaf of
    ``params``, in ``leaves`` order."""
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch, cfg)
        grads = list(torch.autograd.grad(loss, leaves(params)))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _split(v: torch.Tensor, microbatches: int) -> torch.Tensor:
    """(B, ...) → (microbatches, B / microbatches, ...).  A ``DTensor`` batch
    dim sharded over ranks whose count does not divide ``microbatches``
    cannot be unflattened: it is gathered first, and each microbatch's
    model input is laid out again (``transformer.forward``)."""
    if is_dtensor(v):
        n = 1
        for d, p in enumerate(v.placements):
            if p.is_shard(0):
                n *= v.device_mesh.size(d)
        if microbatches % n:
            v = replicate_dims(v, 0)
    return v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])


def train_step(
    state: TrainState,
    batch: dict,
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    lr_scale=1.0,
    *,
    microbatches: int = 1,
    grad_specs=None,
) -> tuple[TrainState, dict]:
    """One optimizer step → (state, {"ce", "aux", "loss", "grad_norm"}).

    ``microbatches > 1`` splits the batch along axis 0, accumulates f32
    gradients, divides them by the count and averages the metrics, as the
    reference's scan does.  ``grad_specs`` (a spec tree matching params,
    ``distributed.sharding.param_specs``) pins the gradients and the f32
    accumulator to the parameter layout under an active mesh, at the
    reference's four sites; the identity on plain tensors."""
    params = state.params

    def pin(g: list) -> list:
        return leaves(constrain_tree(unflatten(params, g), grad_specs))

    if microbatches == 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg)
        grads = pin(grads)
    else:
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} not divisible by microbatches {microbatches}")
        mb = {k: _split(v, microbatches) for k, v in batch.items()}
        grads = pin([torch.zeros_like(p, dtype=torch.float32, requires_grad=False) if is_dtensor(p)
                     else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves(params)])
        loss, per = 0.0, []
        for i in range(microbatches):
            l, m, g = _value_and_grad(params, {k: v[i] for k, v in mb.items()}, cfg)
            for acc, gi in zip(grads, pin(g)):
                acc.add_(gi)
            grads = pin(grads)
            loss = loss + l
            per.append(m)
            del g
        for acc in grads:
            acc.div_(microbatches)
        loss = loss / microbatches
        metrics = {k: torch.mean(torch.stack([m[k] for m in per])) for k in per[0]}
    grads = unflatten(params, grads)
    ef = state.ef
    if ef is not None:
        grads, ef = compression.compress_grads(grads, ef)
    params, opt, gnorm = adamw.update(grads, state.opt, state.params, opt_cfg, lr_scale)
    metrics = dict(metrics, loss=loss, grad_norm=gnorm)
    return TrainState(params=params, opt=opt, ef=ef), metrics


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *, microbatches: int = 1):
    """The step with the model and optimizer configs bound."""

    def step(state: TrainState, batch: dict, lr_scale=1.0):
        return train_step(state, batch, cfg, opt_cfg, lr_scale, microbatches=microbatches)

    return step
