"""Training launcher — port of ``repro/launch/train.py``: the
fault-tolerant loop (checkpoints, deterministic resume, straggler logging)
on one device, the card unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --preset tiny --steps 50 --ckpt-dir ckpt [--device cpu]

``--preset tiny`` trains ``configs.reduced(arch)``, ``small`` a 512-wide
8-layer cut, ``full`` the registered config (qwen2.5-3b full: 3.09·10⁹
parameters, 37 GB of state with the f32 moments).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.train import loop as loop_mod


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=configs.ARCH_NAMES)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    if args.preset == "tiny":
        cfg = configs.reduced(args.arch)
    elif args.preset == "small":
        cfg = configs.reduced(
            args.arch, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, n_layers=8,
            vocab_size=32768,
        )
    else:
        cfg = configs.get(args.arch)

    n_params = cfg.param_counts()
    print(f"arch={cfg.name} preset={args.preset} params={n_params['total']/1e6:.1f}M "
          f"(active {n_params['active']/1e6:.1f}M) device={dev}")

    loop = loop_mod.LoopConfig(
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        seed=args.seed,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        async_ckpt=True,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        fail_at_step=args.fail_at_step,
        step_deadline_s=60.0,
    )
    out = loop_mod.run(cfg, loop, device=dev)
    print(f"done: start_step={out['start_step']} final_loss={out['losses'][-1]:.4f} "
          f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
