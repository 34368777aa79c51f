"""Serving launcher — port of ``repro/launch/serve.py``: batched generation
with a growth-on-demand KV cache, on the card unless ``--device`` says
otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --policy ggarray --new-tokens 32 [--device cpu]

Like the reference it serves the reduced model (``configs.reduced(arch,
cache_b0=16)``) with random weights, under any of the engine's policies
(``static``, ``semistatic``, ``ggarray``, ``two_phase``; the reference lists
the first three).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.serving.engine import ENGINE_POLICIES, Engine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=configs.ARCH_NAMES)
    ap.add_argument("--policy", default="ggarray", choices=ENGINE_POLICIES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = configs.reduced(args.arch, cache_b0=16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen)
    eng = Engine(params, cfg, policy=args.policy, max_len=args.max_len, device=dev)

    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(3 + i)] for i in range(args.batch)]
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=args.new_tokens, temperature=args.temperature)
    dt = time.perf_counter() - t0
    s = eng.stats
    tput = args.batch * args.new_tokens / dt
    print(f"policy={args.policy} device={dev} tokens/s={tput:.1f} grow_events={s.grow_events} "
          f"copied={s.copied_bytes/1e6:.2f}MB allocated={s.allocated_bytes/1e6:.2f}MB "
          f"host_syncs={s.host_syncs}")
    for i, seq in enumerate(out[:2]):
        print(f"  seq{i}: {seq[:16]}...")


if __name__ == "__main__":
    main()
