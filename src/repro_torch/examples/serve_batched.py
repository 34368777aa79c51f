"""Batched serving example: the GGArray KV cache end to end — twin of
``examples/serve_batched.py`` on the port.

Serves a small model with batched requests of different lengths, comparing
the three cache policies on the same prompts: identical outputs, different
growth behaviour (copy-free vs copying vs worst-case pre-allocation).
Then the same fleet goes through the slab-arena ``BatchEngine``:
continuous batching over one shared pool, identical tokens again, capacity
bounded by live data + one slab a sequence.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --new-tokens 24 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.serving.engine import BatchEngine, Engine


def main(arch: str = "qwen2.5-3b", new_tokens: int = 24,
         device: "str | torch.device | None" = None) -> dict:
    dev = resolve(device)
    cfg = configs.reduced(arch, cache_b0=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [11, 12, 13], [21, 22, 23, 24], [31, 32]]

    outputs, stats = {}, {}
    for policy in ("ggarray", "semistatic", "static"):
        eng = Engine(params, cfg, policy=policy, max_len=256, device=dev)
        t0 = time.perf_counter()
        outputs[policy] = eng.generate(prompts, max_new_tokens=new_tokens)
        dt = time.perf_counter() - t0
        s = eng.stats
        stats[policy] = {"grow_events": s.grow_events, "copied_bytes": s.copied_bytes,
                         "allocated_bytes": s.allocated_bytes}
        print(
            f"{policy:10s}: {len(prompts) * new_tokens / dt:7.1f} tok/s  "
            f"grows={s.grow_events}  copied={s.copied_bytes / 1e3:.1f}KB  "
            f"allocated={s.allocated_bytes / 1e3:.1f}KB"
        )

    assert outputs["ggarray"] == outputs["semistatic"] == outputs["static"], (
        "all cache policies must produce identical tokens"
    )
    print("✓ identical generations across policies")

    # the slab arena: 2 decode slots serve all 4 requests through one pool
    be = BatchEngine(params, cfg, max_batch=2, device=dev)
    t0 = time.perf_counter()
    paged = be.run_all(prompts, new_tokens)
    dt = time.perf_counter() - t0
    s = be.stats
    print(
        f"{'paged':10s}: {len(prompts) * new_tokens / dt:7.1f} tok/s  "
        f"pool={s.peak_pool_tokens} tok  peak_live={s.peak_live_tokens} tok  "
        f"reused_slabs={s.reused_slabs}  host_syncs={s.host_syncs}"
    )
    assert paged == outputs["ggarray"], "paged must match the ggarray oracle"
    assert s.peak_pool_tokens < 2 * s.peak_live_tokens + cfg.slab_tokens * be.B
    print("✓ paged BatchEngine matches bit-for-bit within the capacity bound")
    print("sample:", outputs["ggarray"][0][:12], "...")
    return {"outputs": outputs, "paged": paged, "stats": stats,
            "pool": s.peak_pool_tokens, "peak_live": s.peak_live_tokens}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args()
    main(args.arch, args.new_tokens, args.device)
