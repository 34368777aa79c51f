"""MoE dispatch IS parallel insertion — twin of ``examples/moe_dispatch.py``
on the port.

Routes a batch of tokens to experts and computes each token's buffer slot
with the paper's three insertion algorithms — experts play the role of
LFVector blocks.  Shows the GGArray-geometry capacity (no token drops at
≤2× memory) vs a fixed capacity factor (drops).

    PYTHONPATH=src python -m repro_torch.examples.moe_dispatch [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.core.insertion import insertion_offsets
from repro_torch.device import resolve
from repro_torch.models import moe as moe_mod


def main(device: "str | torch.device | None" = None) -> dict:
    dev = resolve(device)
    cfg = configs.reduced("dbrx-132b")  # 4 experts top-2 reduced
    moe = cfg.moe
    T = 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xt = torch.randn((T, cfg.d_model), generator=gen, device=dev)

    params = moe_mod.init_moe(gen, cfg, torch.float32)
    probs, gate, expert = moe_mod.route(params, xt, cfg)
    flat_expert = expert.reshape(-1)
    assign = (flat_expert[None, :] == torch.arange(moe.n_experts, device=dev)[:, None]).to(torch.int32)

    print(f"{T} tokens → {moe.n_experts} experts (top-{moe.top_k})")
    print("per-expert load:", torch.sum(assign, dim=1))
    counts = {}
    for method in ("atomic", "scan", "mxu"):
        offsets, cnt = insertion_offsets(assign.bool(), method=method)
        rank = torch.gather(offsets, 0, flat_expert[None, :])[0]
        counts[method] = cnt
        print(f"  insertion[{method}]: max rank per expert = {cnt} (unique slots ✓)")

    # capacity: fixed factor (drops) vs GGArray geometry (≤2x, no drops)
    fixed = moe_mod.expert_capacity(moe, T)
    gg = moe_mod.expert_capacity(dataclasses.replace(moe, ggarray_capacity=True), T)
    load = int(torch.max(torch.sum(assign, dim=1)))
    print(f"capacity: fixed-factor={fixed} (drops if load>{fixed}), "
          f"ggarray-bucket={gg} (max load {load})")

    out, aux = moe_mod.moe_block(params, xt[None], cfg)
    print(f"moe_block out shape={tuple(out.shape)}, aux loss={float(aux):.4f}")
    return {"counts": counts, "rank": rank, "fixed": fixed, "ggarray": gg, "load": load,
            "out_shape": tuple(out.shape)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(ap.parse_args().device)
