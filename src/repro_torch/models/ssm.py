"""Mamba-2 (SSD, state-space duality) layer — port of ``repro/models/ssm.py``.

Prefill runs the chunked SSD algorithm: quadratic attention-like work
within a chunk, a linear recurrence across chunk states.  Decode carries an
O(1) recurrent state per layer (the conv window and the SSD state), so an
SSM layer has no KV cache.  Jamba's Mamba slots reuse this layer.

The arithmetic is the reference's step for step (f32 inside the scan, the
activations' dtype at the projections), with one difference of form: each
of the reference's three-operand einsums is contracted pairwise, the
elementwise product first, so no six-dimensional intermediate is made (at
Jamba's width one layer's (B, chunks, heads, Q, Q) f32 block is already
0.94 GB at 4 × 1792 tokens).  The reference's chunk-grid rule is kept:
``Q = chunk_size`` when resuming from a state, else ``min(chunk_size, L)``,
with ``dt`` zeroed on the pad steps so they leave the state unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (is_dtensor, local_region, logical_spec, merge_ready,
                                             merge_ready_grad, mesh_axes, placements, reduce_partial)
from repro_torch.models.modules import Param, dense_init, rms_norm

__all__ = ["init_mamba", "mamba_block", "mamba_decode_step", "init_mamba_state", "MambaState"]

_F32 = torch.float32


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner + 2*g*n) — rolling conv window
    ssd: torch.Tensor  # (B, nh, hd, n) f32 — recurrent SSD state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_ssm_heads(cfg.d_model)
    return s, di, nh, s.head_dim, s.n_groups, s.d_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
               lead: tuple[int, ...] = ()) -> Param:
    """Separate projections, as the reference keeps them; ``A_log``, ``D``
    and ``dt_bias`` stay f32 whatever ``dtype`` is."""
    s, di, nh, hd, g, n = _dims(cfg)
    d = cfg.d_model
    conv_ch = di + 2 * g * n
    dev = gen.device

    def const(shape, value, dt):
        return torch.full((*lead, *shape), value, dtype=dt, device=dev)

    return {
        "wz": dense_init(gen, (d, di), dtype, lead=lead),
        "wx": dense_init(gen, (d, di), dtype, lead=lead),
        "wBC": dense_init(gen, (d, 2 * g * n), dtype, lead=lead),
        "wdt": dense_init(gen, (d, nh), dtype, lead=lead),
        "conv_w": dense_init(gen, (s.d_conv, conv_ch), dtype, s.d_conv, lead=lead),
        "conv_b": const((conv_ch,), 0.0, dtype),
        "A_log": const((nh,), 0.0, _F32),
        "D": const((nh,), 1.0, _F32),
        "dt_bias": const((nh,), 0.0, _F32),
        "norm_w": const((di,), 1.0, dtype),
        "out_proj": dense_init(gen, (di, d), dtype, lead=lead),
    }


def _split_proj(p: Param, x: torch.Tensor):
    x = merge_ready(x)
    z = x @ p["wz"]
    xBC = torch.cat([x @ p["wx"], x @ p["wBC"]], dim=-1)
    dt = x @ p["wdt"]
    return z, xBC, dt


def _causal_conv(w: torch.Tensor, b: torch.Tensor, xBC: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Depthwise causal conv along L via shifted adds (the window is tiny)."""
    out = xBC * w[-1]
    L = xBC.shape[1]
    for i in range(1, d_conv):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :L]
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def _conv(w, b, xBC, *hist, pad: int):
    """The causal conv of the projections ``xBC`` (B, L, ch) behind
    ``hist`` (B, d_conv − 1, ch), the raw history a resumed call reaches
    back into (zeros without one), padded by ``pad`` steps → (the conv's
    output (B, L + pad, ch), the last d_conv − 1 raw steps: the next call's
    history)."""
    d_conv = w.shape[0]
    hist = hist[0].to(xBC.dtype) if hist else xBC.new_zeros((xBC.shape[0], d_conv - 1, xBC.shape[-1]))
    xBC = torch.cat([hist, xBC], dim=1)  # (B, d_conv-1 + L, ch)
    tail = xBC[:, xBC.shape[1] - (d_conv - 1):, :]
    if pad:
        xBC = F.pad(xBC, (0, 0, 0, pad))
    return _causal_conv(w, b, xBC, d_conv)[:, d_conv - 1:], tail


def _conv_region(conv, args: tuple):
    """``conv(*args)`` (``_conv``) on a mesh, in a ``local_map`` region: the
    batch split as the data axes split it, the sequence and the channels
    whole on every rank (the conv runs along the sequence; its pads and
    shifts of a ``DTensor`` rest on a torch version's rules).  The weights'
    gradients are the ranks' shares of a sum over the batch."""
    from torch.distributed.tensor import Partial, Replicate

    xBC = args[2]
    mesh = xBC.device_mesh
    batch = placements((logical_spec(tuple(xBC.shape[:1]), ("batch",), mesh)[0], None, None), mesh)
    whole = [Replicate()] * mesh.ndim
    summed = [Partial() if q.is_shard() else Replicate() for q in batch]
    ins = (whole, whole, batch, batch)[:len(args)]
    return local_region(conv, mesh, ins, (batch, batch), (summed, summed, *ins[2:]))(*args)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j<k<=i} dA[k] for i >= j, else -inf.  dA: (..., Q)."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ar = torch.arange(Q, device=dA.device)
    return torch.where(ar[:, None] >= ar[None, :], diff, -torch.inf)


def _heads(x: torch.Tensor, hpg: int) -> torch.Tensor:
    """(..., g, n) → (..., g·hpg, n): each group's row repeated for its
    heads (``jnp.repeat`` on the group axis), by a broadcast, not a
    ``repeat_interleave``."""
    *lead, g, n = x.shape
    return x[..., None, :].expand(*lead, g, hpg, n).reshape(*lead, g * hpg, n)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssd(xs, Bm, Cm, dt, A_log, D, dt_bias, ssd0=None, *, L: int, Q: int, g: int, hd: int,
         out_dtype: torch.dtype):
    """The SSD scan of the conv's outputs → (y (B, L, di) in ``out_dtype``,
    the final state (B, nh, hd, n) f32).  xs (B, Lp, di), Bm/Cm (B, Lp,
    g·n), dt (B, L, nh) raw; ``ssd0`` the state entering the first chunk.
    A head reads only its own slices of xs, dt, A_log, D and dt_bias (and
    its group's of Bm, Cm), so a mesh runs a slice of the heads on each
    rank's local tensors (``_ssd_region``)."""
    B, Lp, di = xs.shape
    nh = dt.shape[-1]
    n = Bm.shape[-1] // g
    hpg = nh // g
    nc = Lp // Q
    if Lp != L:
        dt = F.pad(dt, (0, 0, 0, Lp - L))
    dt = _softplus(dt.to(_F32) + dt_bias)  # (B, Lp, nh)
    if Lp != L:
        dt = dt * (torch.arange(Lp, device=xs.device) < L).to(dt.dtype)[None, :, None]
    A = -torch.exp(A_log)  # (nh,)
    dA = dt * A  # (B, Lp, nh) log-decay
    xc = xs.reshape(B, nc, Q, nh, hd).to(_F32)
    Bh = _heads(Bm.reshape(B, nc, Q, g, n).to(_F32), hpg)  # (B, nc, Q, nh, n)
    Ch = _heads(Cm.reshape(B, nc, Q, g, n).to(_F32), hpg)
    dtc = dt.reshape(B, nc, Q, nh)
    dAc = dA.reshape(B, nc, Q, nh)

    # ---- within-chunk (quadratic, attention-like) ----
    Lmat = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))  # (B, nc, nh, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)  # (B, nc, nh, Q, Q)
    xdt = xc * dtc[..., None]  # (B, nc, Q, nh, hd)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * Lmat, xdt)
    del Lmat, scores

    # ---- chunk states ----
    cs = torch.cumsum(dAc, dim=2)  # (B, nc, Q, nh)
    tot = cs[:, :, -1:, :]  # (B, nc, 1, nh)
    decay_to_end = torch.exp(tot - cs)
    chunk_states = torch.einsum(
        "bcqhn,bcqhp->bchpn", Bh, (decay_to_end * dtc)[..., None] * xc
    )  # (B, nc, nh, hd, n)

    # ---- inter-chunk recurrence: the state entering each chunk ----
    chunk_decay = torch.exp(tot[:, :, 0, :])  # (B, nc, nh)
    carry = ssd0.to(_F32) if ssd0 is not None else xs.new_zeros((B, nh, hd, n), dtype=_F32)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, nh, hd, n)

    # ---- state → output ----
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch * torch.exp(cs)[..., None], prev_states)
    y = (y_diag + y_off).reshape(B, Lp, nh, hd)
    y = y + xs.to(_F32).reshape(B, Lp, nh, hd) * D[None, None, :, None]
    return y.reshape(B, Lp, di)[:, :L].to(out_dtype), carry


def _ssd_region(core, args: tuple, g: int):
    """``core(*args)`` (``_ssd``) on a mesh, in a ``local_map`` region: the
    batch split as the data axes split it, the heads over ``'model'`` where
    they divide and share one group, Bm and Cm whole on every rank of
    ``'model'``.  Each rank runs the unmeshed scan on its own batch and
    heads, so no view of a sharded ``DTensor`` is left to a torch version's
    rule (the scan's einsums fold the batch, chunk and head dims).  A
    rank's gradient of an input it reads whole over a mesh dim that splits
    the work is its share of a sum (``Partial``): Bm's and Cm's over the
    heads' dim, A_log's, D's and dt_bias's over the batch's."""
    from torch.distributed.tensor import Partial

    xs, dt = args[0], args[3]
    mesh = xs.device_mesh
    sizes = mesh_axes(mesh)
    nh = dt.shape[-1]
    heads = "model" if g == 1 and "model" in sizes and nh % sizes["model"] == 0 else None
    batch = logical_spec(tuple(xs.shape[:1]), ("batch",), mesh)[0]
    by_head = placements((batch, None, heads), mesh)
    whole = placements((batch, None, None), mesh)
    vec = placements((heads,), mesh)
    state = placements((batch, heads, None, None), mesh)
    ins = (by_head, whole, whole, by_head, vec, vec, vec, state)[:len(args)]

    def summed(place, over):  # Partial() on the mesh dims where ``over`` shards
        return [Partial() if o.is_shard() and not q.is_shard() else q for q, o in zip(place, over)]

    grads = (by_head, summed(whole, by_head), summed(whole, by_head), by_head, *(summed(vec, whole),) * 3,
             state)[:len(args)]
    return local_region(core, mesh, ins, (by_head, state), grads)(*args)


def mamba_block(
    p: Param,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: MambaState | None = None,
    *,
    return_state: bool = False,
):
    """Full-sequence SSD pass. x: (B, L, D) → (B, L, D) [, final MambaState].

    ``state`` makes this a resumable chunk step (chunked prefill):
    ``state.ssd`` seeds the inter-chunk recurrence and ``state.conv`` is the
    raw pre-conv history the causal conv reaches back into.
    """
    s, di, nh, hd, g, n = _dims(cfg)
    L = x.shape[1]
    # a resumed call keeps the full chunk grid, so a short tail pads up to
    # the Q the monolithic pass used (pad steps are state-neutral)
    Q = s.chunk_size if state is not None else min(s.chunk_size, L)
    pad = (-L) % Q

    z, xBC, dt = _split_proj(p, x)
    conv = lambda *a: _conv(*a, pad=pad)  # noqa: E731
    args = (p["conv_w"], p["conv_b"], xBC, *(() if state is None else (state.conv,)))
    xBC, conv_tail = _conv_region(conv, args) if is_dtensor(xBC) else conv(*args)
    xs, Bm, Cm = torch.split(xBC, [di, g * n, g * n], dim=-1)
    ssd0 = () if state is None else (state.ssd,)
    core = lambda *a: _ssd(*a, L=L, Q=Q, g=g, hd=hd, out_dtype=x.dtype)  # noqa: E731
    args = (xs, Bm, Cm, dt, p["A_log"], p["D"], p["dt_bias"], *ssd0)
    y, carry = _ssd_region(core, args, g) if is_dtensor(xs) else core(*args)

    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = merge_ready_grad(y @ p["out_proj"])
    if return_state:
        return out, MambaState(conv=conv_tail, ssd=carry)
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: "torch.device | str | None" = None, *,
                     lead: tuple[int, ...] = ()) -> MambaState:
    """A zero state, ``lead`` (the period axis of a cache slot) before the
    batch; ``device=None`` means the card."""
    from repro_torch.device import resolve

    s, di, nh, hd, g, n = _dims(cfg)
    dev = resolve(device)
    return MambaState(
        conv=torch.zeros((*lead, batch, s.d_conv - 1, di + 2 * g * n), dtype=dtype, device=dev),
        ssd=torch.zeros((*lead, batch, nh, hd, n), dtype=_F32, device=dev),
    )


def _read_state(Ch: torch.Tensor, ssd: torch.Tensor) -> torch.Tensor:
    """einsum("bhn,bhpn->bhp"): the state (B, nh, hd, n) read by Ch.  On a
    mesh in a ``local_map`` region, each rank its batch and, where they
    divide over ``'model'``, its heads: the einsum folds the batch and the
    heads into one dim, both sharded, which a view of a ``DTensor`` leaves
    to a torch version's rule (2.13 flattens it, 2.11 refuses)."""
    read = lambda c, h: torch.einsum("bhn,bhpn->bhp", c, h)  # noqa: E731
    if not is_dtensor(ssd):
        return read(Ch, ssd)
    mesh = ssd.device_mesh
    sizes = mesh_axes(mesh)
    heads = "model" if "model" in sizes and ssd.shape[1] % sizes["model"] == 0 else None
    batch = logical_spec(tuple(ssd.shape[:1]), ("batch",), mesh)[0]
    by_head = placements((batch, heads, None), mesh)
    return local_region(read, mesh, (by_head, placements((batch, heads, None, None), mesh)), by_head)(Ch, ssd)


def mamba_decode_step(
    p: Param, x: torch.Tensor, state: MambaState, cfg: ModelConfig
) -> tuple[torch.Tensor, MambaState]:
    """One-token recurrent step. x: (B, 1, D) → (B, 1, D), new state."""
    s, di, nh, hd, g, n = _dims(cfg)
    B = x.shape[0]
    z, xBC, dt = _split_proj(p, x)  # (B, 1, ...)
    # on a mesh the gate's and dt's pending sums over a sharded D are
    # reduced before their activations, not where a torch version's rule
    # for them chooses
    z, dt = reduce_partial(z), reduce_partial(dt)
    xBC = xBC[:, 0]

    window = torch.cat([state.conv, xBC[:, None]], dim=1)  # (B, d_conv, ch)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out)
    new_conv = window[:, 1:]

    xs, Bm, Cm = torch.split(xBC, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(B, nh, hd).to(_F32)
    hpg = nh // g
    Bh = _heads(Bm.reshape(B, g, n).to(_F32), hpg)  # (B, nh, n)
    Ch = _heads(Cm.reshape(B, g, n).to(_F32), hpg)

    dt = _softplus(dt[:, 0].to(_F32) + p["dt_bias"])  # (B, nh)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, nh)

    new_ssd = state.ssd * decay[..., None, None] + (dt[..., None] * xs)[..., None] * Bh[:, :, None, :]
    y = _read_state(Ch, new_ssd) + xs * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(conv=new_conv, ssd=new_ssd)
