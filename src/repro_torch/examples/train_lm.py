"""End-to-end training example — twin of ``examples/train_lm.py`` on
the port.

Trains a small qwen-family model with the full substrate: deterministic
data, AdamW + warmup-cosine, checkpointing, resume.  The default is a fast
preset; ``--model-size 100m --steps 300`` is the ~100M-parameter run for a
card.  Checkpoints go under the temporary directory unless ``--ckpt-dir``
says otherwise; a directory that holds one resumes from it.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 [--device cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.train import loop as loop_mod

DIMS = {
    "2m": dict(d_model=128, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=4096),
    "10m": dict(d_model=256, n_layers=6, n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192),
    "100m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=32768),
}


def main(model_size: str = "10m", steps: int = 200, ckpt_dir: str | None = None, batch: int = 8,
         seq: int = 128, device: "str | torch.device | None" = None) -> dict:
    dev = resolve(device)
    cfg = configs.reduced("qwen2.5-3b", **DIMS[model_size])
    print(f"model: {cfg.param_counts()['total'] / 1e6:.1f}M params")
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")

    losses = []
    out = loop_mod.run(
        cfg,
        loop_mod.LoopConfig(
            steps=steps,
            batch=batch,
            seq=seq,
            ckpt_dir=ckpt_dir,
            ckpt_every=50,
            async_ckpt=True,
            warmup=20,
            lr=3e-4,
            log_every=20,
        ),
        on_metrics=lambda it, m: losses.append(float(m["loss"])),
        device=dev,
    )
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss: {first:.3f} → {last:.3f} over {len(out['losses'])} steps "
          f"(resumed from {out['start_step']})")
    assert last < first, "training should reduce loss"
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-size", default="10m", choices=list(DIMS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args()
    main(args.model_size, args.steps, args.ckpt_dir, args.batch, args.seq, args.device)
