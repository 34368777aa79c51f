"""The fault-tolerant training loop — port of ``repro/train/loop.py``.

- **checkpoint/restart**: periodic (optionally async) checkpoints; on start
  the loop resumes from the newest complete checkpoint.
- **deterministic resume**: batches are a function of (seed, step)
  (``data/synthetic.make_batch``), so a restarted run recomputes the same
  batch sequence and its losses match an uninterrupted run's bitwise (on a
  card, under ``torch.use_deterministic_algorithms(True)``: the backward of
  an index accumulates with atomics otherwise).
- **failure injection**: ``fail_at_step`` raises mid-run, to exercise the
  restart path.
- **straggler counting**: a step slower than ``step_deadline_s`` is
  counted and logged.
- **emergency checkpoint**: pending async writes are finished on a crash.

``run`` takes ``device`` (the card unless ``device="cpu"``); the
``LoopConfig`` is the reference's, field for field.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve
from repro_torch.optim import adamw, schedule
from repro_torch.train import step as step_mod

__all__ = ["LoopConfig", "run"]


@dataclasses.dataclass
class LoopConfig:
    steps: int = 20
    batch: int = 8
    seq: int = 64
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 10
    async_ckpt: bool = False
    microbatches: int = 1
    warmup: int = 5
    lr: float = 1e-3
    grad_compression: bool = False
    fail_at_step: int | None = None  # failure injection (tests)
    step_deadline_s: float | None = None  # straggler threshold
    log_every: int = 10


def run(
    cfg: ModelConfig,
    loop: LoopConfig,
    *,
    on_metrics: Callable[[int, dict], None] | None = None,
    device: "str | torch.device | None" = None,
) -> dict:
    """Train → {'losses': [...], 'start_step': int, 'stragglers': int}."""
    dev = resolve(device)
    opt_cfg = adamw.AdamWConfig(lr=loop.lr)
    state = step_mod.init_train_state(loop.seed, cfg, grad_compression=loop.grad_compression,
                                      device=dev)
    start_step = 0
    if loop.ckpt_dir:
        latest = ckpt.latest_step(loop.ckpt_dir)
        if latest is not None:
            state, meta = ckpt.restore(loop.ckpt_dir, latest, state)
            start_step = int(meta.get("next_step", latest))

    losses: list[float] = []
    stragglers = 0
    try:
        for it in range(start_step, loop.steps):
            if loop.fail_at_step is not None and it == loop.fail_at_step:
                raise RuntimeError(f"injected failure at step {it}")
            batch = make_batch(cfg, loop.batch, loop.seq, seed=loop.seed, step=it, device=dev)
            lr_scale = schedule.warmup_cosine(it, warmup=loop.warmup, total=loop.steps)
            t0 = time.monotonic()
            state, metrics = step_mod.train_step(state, batch, cfg, opt_cfg, lr_scale,
                                                 microbatches=loop.microbatches)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            if loop.step_deadline_s is not None and dt > loop.step_deadline_s:
                stragglers += 1
                print(f"[straggler] step {it} took {dt:.3f}s > {loop.step_deadline_s}s")
            losses.append(loss)
            if on_metrics:
                on_metrics(it, metrics)
            if loop.ckpt_dir and (it + 1) % loop.ckpt_every == 0:
                saver = ckpt.save_async if loop.async_ckpt else ckpt.save
                saver(loop.ckpt_dir, it + 1, state, metadata={"next_step": it + 1})
            if (it + 1) % loop.log_every == 0:
                print(f"step {it + 1}/{loop.steps} loss={loss:.4f}")
    except Exception:
        if loop.ckpt_dir:  # emergency: finish pending writes (best effort)
            try:
                ckpt.wait_pending()
            except Exception:
                pass
        raise
    finally:
        if loop.ckpt_dir:
            ckpt.wait_pending()
    return {"losses": losses, "start_step": start_step, "stragglers": stragglers}
