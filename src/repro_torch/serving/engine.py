"""Batched serving engines with growth-on-demand KV caches — port of
``repro/serving/engine.py``.

:class:`Engine` serves one batch under a cache policy: prompts are
prefilled into a cache sized for the prompt only, then decode pushes tokens
until capacity, where the policy's growth event fires:

- ``ggarray``    ``grow_ggarray`` appends the next geometric bucket — **no
                 copy** (decode appends are K3, k and v in one launch);
- ``semistatic`` realloc: allocate 2x and copy every K/V byte;
- ``static``     no growth: the cache is pre-allocated to ``max_len``;
- ``two_phase``  prefill grows a ggarray cache, which is then frozen into
                 the contiguous layout; on capacity the engine thaws, adds a
                 bucket and refreezes (one O(n) copy per growth event).

:class:`BatchEngine` serves the ``paged`` policy with continuous batching
over one shared slab pool: chunked
admission (``serving/scheduler``), batched decode, slab reclamation, flat
pools grown by realloc (``grow_chunk`` 1 or ``"geometric"``) or extent
pools grown copy-free (``"doubling"``, ``"tz"``).

Both follow the reference's host-sync-free protocol: the growth check is
host arithmetic on a length mirror, sampled tokens stay on the device, and
one audited read (``serve.host_syncs{site=…}``) materialises them after the
loop.  Host data reaches the card with ``non_blocking`` copies
(``kernels.common.to_device``), so a steady-state decode step makes no
synchronising call at all.

``instrument=True`` turns on the device counter plane (K15): each step
hands its counter vector to ``devctr`` (a list append, no transfer) and
``drain_device_counters()`` reads the totals.  ``BatchEngine`` also keeps
a flight recorder (``obs.flight``): a quota failure, a failed step (dumped
once) and a failed ``check_free_list`` write a postmortem bundle of the
engine's host state before the exception propagates.

Both serve every decoder layout of the reference: attention, Mamba
(pure SSM or the Jamba hybrid) and MoE stacks.  Growth, freezing, the page
tables and the pool touch attention slots only; a Mamba slot's cache is its
recurrent state, sized by the batch.  ``Engine`` also serves encoder–decoder
and prefix-embedding configs as decoder-only stacks (its ``generate``
passes neither memory nor prefix, as the reference's); ``BatchEngine``
refuses them, as the reference does.

Not ported yet (ROADMAP.md, Queue 1), each raising
``NotImplementedError``: int8 caches, monolithic admission and
``prefix_cache=True``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.common import to_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import DTYPES, check_supported
from repro_torch.obs import DeviceCounterPlane, ServingTimeline
from repro_torch.serving import kvcache, scheduler as sched_mod, steps
from repro_torch.serving.sampler import sample

__all__ = ["Engine", "EngineStats", "ENGINE_POLICIES", "BatchEngine", "BatchStats", "Request"]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1 items 14, 15 and 17)")


def _params_device(params: dict, device) -> torch.device:
    """The engine's device: the card unless ``device`` says otherwise
    (``device.resolve``); the parameters must already live there."""
    dev = resolve(device)
    here = params["embed"].device
    if here.type != dev.type:
        raise ValueError(f"parameters live on {here}, the engine runs on {dev}: "
                         f"make them there (pass device='cpu' to serve on the CPU)")
    return here


class _StatsView:
    """Read-only properties over an ``obs`` metrics registry."""

    def __init__(self, registry):
        self._reg = registry

    def _ct(self, name: str) -> int:
        return int(self._reg.counter(name).total())

    def _hwm(self, name: str) -> int:
        return int(self._reg.gauge(name).hwm())

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{n}={getattr(self, n)}"
            for n in dir(type(self))
            if isinstance(getattr(type(self), n), property)
        )
        return f"{type(self).__name__}({fields})"


class EngineStats(_StatsView):
    """Engine counters — a view over ``engine.obs.registry``.  The
    reference's ``compiles`` has no meaning without ``jit`` and is not kept."""

    grow_events = property(lambda s: s._ct("engine.grow_events"))
    freeze_events = property(lambda s: s._ct("engine.freeze_events"))
    copied_bytes = property(lambda s: s._ct("engine.copied_bytes"))
    allocated_bytes = property(lambda s: s._ct("engine.allocated_bytes"))
    decode_steps = property(lambda s: s._ct("engine.decode_steps"))
    host_syncs = property(lambda s: s._ct("serve.host_syncs"))


ENGINE_POLICIES = ("static", "semistatic", "ggarray", "two_phase")


class Engine:
    """``Engine(params, cfg, policy=...)``: batched generation over a KV
    cache of one of :data:`ENGINE_POLICIES`, on the parameters' device."""

    def __init__(
        self,
        params: dict,
        cfg: ModelConfig,
        *,
        policy: str | None = None,
        max_len: int = 4096,
        instrument: bool = False,
        seed: int = 0,
        obs: ServingTimeline | None = None,
        device: "torch.device | str | None" = None,
    ):
        check_supported(cfg)
        self.policy = cfg.cache_policy if policy is None else policy
        if self.policy == "paged":
            raise ValueError(
                "the paged (slab-arena) policy is served by BatchEngine, "
                "which owns the pool/page-table lifecycle"
            )
        if self.policy not in ENGINE_POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; options: {ENGINE_POLICIES}")
        if instrument:
            cfg = dataclasses.replace(cfg, instrument=True)
        if cfg.cache_quant:
            raise _not_ported("the int8 KV cache (cache_quant)")
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params, device)
        self.max_len = max_len
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.obs = obs if obs is not None else ServingTimeline()
        self.stats = EngineStats(self.obs.registry)
        self.devctr = DeviceCounterPlane(self.obs.registry)

    def drain_device_counters(self) -> dict[str, float]:
        """Flush + read the device counter plane → {slot: total}.  A drain
        point (one read per slot with pending adds): call it at the end of a
        run, never per step."""
        return self.devctr.counters()

    def _host_read(self, x: torch.Tensor, site: str) -> np.ndarray:
        """The audited device→host read: every transfer lands in one metric."""
        self.obs.registry.counter("serve.host_syncs", "device→host reads, by site").inc(site=site)
        return x.cpu().numpy()

    def _capacity(self, caches) -> int:
        for c, kind in zip(caches, self.cfg.layout):
            if kind == "attn":
                return kvcache.capacity_of(c)
        return 1 << 30  # attention-free: no cache capacity limit

    def _grow(self, caches) -> list:
        """The policy's growth event; counts allocated and copied bytes."""
        reg = self.obs.registry
        reg.counter("engine.grow_events").inc()
        self.obs.event("grow", policy=self.policy)
        cfg = self.cfg
        out = []
        for c, kind in zip(caches, cfg.layout):
            if kind != "attn":  # a Mamba state does not grow
                out.append(c)
                continue
            if self.policy == "ggarray":
                grown = kvcache.grow_ggarray(c, cfg)
                reg.counter("engine.allocated_bytes").inc(
                    kvcache.cache_bytes(grown) - kvcache.cache_bytes(c))
            elif self.policy == "two_phase":
                # thaw → add a bucket (copy-free) → refreeze for flat decode
                thawed = kvcache.grow_ggarray(kvcache.thaw_cache(c, cfg.cache_b0), cfg)
                grown = kvcache.freeze_cache(thawed)
                reg.counter("engine.copied_bytes").inc(kvcache.cache_bytes(c))
                reg.counter("engine.allocated_bytes").inc(
                    kvcache.cache_bytes(grown) - kvcache.cache_bytes(c))
                reg.counter("engine.freeze_events").inc()
            elif self.policy == "semistatic":
                # the copy of realloc, which GGArray avoids
                grown = dict(c)
                for key in ("k", "v"):
                    old = c[key]
                    cap = old.shape[-3]
                    grown[key] = old.new_zeros((*old.shape[:-3], cap * 2, *old.shape[-2:]))
                    grown[key][..., :cap, :, :] = old
                reg.counter("engine.allocated_bytes").inc(
                    kvcache.cache_bytes({"k": grown["k"], "v": grown["v"]}))
                reg.counter("engine.copied_bytes").inc(kvcache.cache_bytes(c))
            else:
                raise RuntimeError("static cache cannot grow: pre-allocate max_len")
            out.append(grown)
        return out

    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
    ) -> list[list[int]]:
        cfg = self.cfg
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        Lp = int(lens.max())
        toks = np.zeros((B, Lp), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        lengths = to_device(torch.from_numpy(lens), self.device)
        hint = Lp if self.policy != "static" else self.max_len
        # two_phase: the grow phase is a ggarray prefill, frozen below
        prefill_policy = "ggarray" if self.policy == "two_phase" else self.policy
        with self.obs.span("prefill", batch=B, tokens=int(lens.sum())):
            logits, caches, *ctr = steps.prefill(
                self.params, to_device(torch.from_numpy(toks), self.device), cfg,
                capacity_hint=hint, policy=prefill_policy, lengths=lengths,
            )
            if ctr:
                self.devctr.add(ctr[0])
        if self.policy == "two_phase":
            caches = [kvcache.freeze_cache(c) if kind == "attn" else c
                      for c, kind in zip(caches, cfg.layout)]
            self.obs.registry.counter("engine.freeze_events").inc()
        self.obs.registry.counter("engine.allocated_bytes").inc(
            sum(kvcache.cache_bytes(c) for c, kind in zip(caches, cfg.layout) if kind == "attn"))
        # host mirror of the longest live context: decode appends one slot
        # per step, so the growth check is pure host arithmetic
        max_len_host = Lp
        out = [list(p) for p in prompts]
        sampled = [sample(self.gen, logits, temperature)]
        for _ in range(max_new_tokens - 1):
            if max_len_host + 1 >= self._capacity(caches) and self.policy != "static":
                caches = self._grow(caches)
            with self.obs.span("decode_step"):
                logits, caches, *ctr = steps.decode_step(self.params, sampled[-1], caches,
                                                         lengths, cfg)
                if ctr:
                    self.devctr.add(ctr[0])  # a list append — no transfer
            lengths = lengths + 1
            max_len_host += 1
            self.obs.registry.counter("engine.decode_steps").inc()
            sampled.append(sample(self.gen, logits, temperature))
        # one transfer for the whole generation, after the loop dispatched
        tokens = self._host_read(torch.stack(sampled), "token_drain")  # (T, B)
        for i in range(B):
            out[i].extend(int(t) for t in tokens[:, i])
        self.caches = caches
        return out


# --------------------------------------------------------------------------
# BatchEngine — continuous batching over the slab arena (policy="paged").
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One sequence in flight: prompt in, ``max_new_tokens`` greedy out."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    slot: int = -1
    admit_step: int = -1  # index into the decode stream at admission
    generated: int = 0  # tokens sampled so far (incl. the prefill sample)
    first_tok: Any = None  # device scalar — materialised once, at the end
    done: bool = False
    submit_t: float = 0.0
    queue_wait: float = 0.0
    ttft: float = 0.0  # submit → first sampled token (dispatch wall-clock)
    decode_s: float = 0.0
    tpot_ms: float = 0.0


class BatchStats(_StatsView):
    """BatchEngine counters — a view over ``be.obs.registry``.
    ``prefill_widths`` counts distinct padded chunk widths (the reference
    counts prefill traces, which PyTorch does not have)."""

    admitted = property(lambda s: s._ct("serve.admitted"))
    completed = property(lambda s: s._ct("serve.completed"))
    prefills = property(lambda s: s._ct("serve.prefills"))
    prefill_chunks = property(lambda s: s._ct("serve.prefill_chunks"))
    prefill_widths = property(lambda s: int(s._reg.gauge("serve.prefill_widths").value()))
    decode_steps = property(lambda s: s._ct("serve.decode_steps"))
    pool_grow_events = property(lambda s: s._ct("pool.grow_events"))
    pool_copied_bytes = property(lambda s: s._ct("pool.copied_bytes"))
    grown_slabs = property(lambda s: s._ct("pool.grown_slabs"))
    reused_slabs = property(lambda s: s._ct("pool.reused_slabs"))
    released_slabs = property(lambda s: s._ct("pool.released_slabs"))
    peak_live_tokens = property(lambda s: s._hwm("pool.live_tokens"))
    peak_pool_tokens = property(lambda s: s._hwm("pool.capacity_tokens"))
    host_syncs = property(lambda s: s._ct("serve.host_syncs"))


_POOL_KEYS = ("k_pool", "v_pool")


class BatchEngine:
    """Continuous-batch serving over one shared slab pool, chunked admission.

    ``max_batch`` decode slots run in lockstep; requests stream through
    them: admit (the scheduler reserves the prompt's slabs) → prefill in
    bucket-padded chunks interleaved with decode steps → batched decode
    (idle and prefilling slots are inert: −1 page rows drop their appends,
    length 0 masks their attention) → completion (slabs back to the free
    list).  K/V pools are per period, one page table per sequence.  See the
    reference's class docstring for the growth schedules and bounds.
    """

    def __init__(
        self,
        params: dict,
        cfg: ModelConfig,
        *,
        max_batch: int = 8,
        grow_chunk: int | str = 1,
        quota_slabs: int | None = None,
        stop_token: int | None = None,
        admission: str = "chunked",
        prefill_chunk: int | None = None,
        max_chunks_per_step: int | None = None,
        initial_slabs: int = 0,
        max_pages_hint: int = 0,
        prefix_cache: bool = False,
        instrument: bool = False,
        obs: ServingTimeline | None = None,
        device: "torch.device | str | None" = None,
    ):
        from repro_torch.pool import PageBook, is_extent_schedule

        check_supported(cfg)
        if cfg.n_enc_layers or cfg.n_prefix_embeds:
            raise NotImplementedError("BatchEngine serves decoder-only stacks")
        if admission not in ("chunked", "monolithic"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if admission == "monolithic":
            raise _not_ported("monolithic admission")
        if prefix_cache:
            # when ported, it refuses Mamba layouts as the reference does: a
            # cached prefix carries no conv/SSD state to resume from
            raise _not_ported("prefix_cache=True (serving/prefix.py)")
        if instrument:
            cfg = dataclasses.replace(cfg, instrument=True)
        if cfg.cache_quant:
            raise _not_ported("the int8 KV cache (cache_quant)")
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params, device)
        self.T = cfg.slab_tokens
        self.B = max_batch
        self.grow_chunk = grow_chunk
        self._extent_mode = is_extent_schedule(grow_chunk)
        self._extent_sizes: list[int] = [0] if self._extent_mode else []
        self.stop_token = stop_token
        self.obs = obs if obs is not None else ServingTimeline()
        self.stats = BatchStats(self.obs.registry)
        # device counter plane (DESIGN.md §9.x): the steps hand their
        # counter vectors here; draining stays lazy (Counter.add_lazy)
        self.devctr = DeviceCounterPlane(self.obs.registry)
        self.book = PageBook(max_batch, quota_slabs=quota_slabs)
        dev = self.device
        self.free_dev = torch.ones((0,), dtype=torch.bool, device=dev)
        self._len_host = np.zeros((max_batch,), np.int64)
        self.caches = self._init_caches()
        self.lengths = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self._slots: list[Request | None] = [None] * max_batch
        self._requests: dict[int, Request] = {}
        self._stream: list[torch.Tensor] = []  # sampled (B,) per decode step
        self._next_rid = 0
        self._widths: set = set()
        C = cfg.attention_chunk if prefill_chunk is None else prefill_chunk
        hybrid = "mamba" in cfg.layout
        # chunk boundaries land on the monolithic attention grid, and on the
        # SSD chunk grid for Mamba layouts: chunked = monolithic, bit for bit
        if "attn" in cfg.layout and C % cfg.attention_chunk:
            raise ValueError(
                f"prefill_chunk={C} must be a multiple of attention_chunk={cfg.attention_chunk}"
            )
        if hybrid and C % cfg.ssm.chunk_size:
            raise ValueError(
                f"prefill_chunk={C} must be a multiple of ssm.chunk_size={cfg.ssm.chunk_size}"
            )
        self.sched = sched_mod.Scheduler(
            self.book, slab_tokens=self.T, chunk=C, exact_tail=hybrid,
            max_chunks_per_step=max_chunks_per_step, obs=self.obs,
        )
        if max_pages_hint:
            self._ensure_table_width(max_pages_hint)
        if initial_slabs:
            self._grow_pool(initial_slabs, count=False)

    @property
    def alloc(self):
        return self.book.alloc

    # ---- telemetry helpers ----------------------------------------------
    def _host_read(self, x: torch.Tensor, site: str) -> np.ndarray:
        """The audited device→host read (``serve.host_syncs{site=…}``)."""
        self.obs.registry.counter("serve.host_syncs", "device→host reads, by site").inc(site=site)
        return x.cpu().numpy()

    def _sample_live(self) -> None:
        """Refresh the pool occupancy gauges (host arithmetic only); live
        tokens include the prefilled prefix of in-flight admissions."""
        live = self.live_tokens + sum(int(self.sched.t0[s]) for s in self.sched.prefilling)
        cap = self.pool_tokens
        self.obs.gauge_sample("pool.live_tokens", live)
        self.obs.gauge_sample("pool.capacity_tokens", cap)
        self.obs.gauge_sample("pool.utilization", live / cap if cap else 0.0)

    def drain_device_counters(self) -> dict[str, float]:
        """Flush + read the device counter plane → {slot: total}.  A drain
        point (one read per slot with pending adds): call it at the end of a
        run, never per step."""
        return self.devctr.counters()

    def _flightrec_state(self) -> dict:
        """The engine's host bookkeeping for a postmortem bundle (allocator,
        page tables, scheduler, slots); building it reads no device value."""
        alloc = self.alloc
        return {
            "n_slots": self.B,
            "slab_tokens": self.T,
            "admission": "chunked",
            "extent_sizes": list(self._extent_sizes),
            "len_host": self._len_host.tolist(),
            "slots": [
                None if r is None else {"rid": r.rid, "generated": r.generated,
                                        "max_new_tokens": r.max_new_tokens, "done": r.done}
                for r in self._slots
            ],
            "allocator": {
                "n_slabs": alloc.n_slabs,
                "free_slabs": int(np.sum(alloc.free)),
                "free_ids": np.flatnonzero(alloc.free).tolist(),
                "refcounts": np.asarray(alloc.refcount).tolist(),
                "refcount_sum": int(np.sum(alloc.refcount)),
            },
            "page_tables": [[int(s) for s in self.book.pages_of[slot]] for slot in range(self.B)],
            "reserved_total": int(self.book.reserved_total),
            "scheduler": self.sched.describe(),
            "prefix": None,
            "pinned": {},
        }

    def _flight_dump(self, reason: str, error: BaseException | None = None,
                     invariant: dict | None = None) -> None:
        """Dump a postmortem bundle; never raises, never dumps twice for the
        same exception (nested failure paths re-raise through step())."""
        if error is not None and getattr(error, "_flightrec_dumped", False):
            return
        try:
            state = self._flightrec_state()
            if invariant:
                state["invariant"] = dict(invariant)
            try:
                metrics = self.obs.snapshot()  # lazy-counter drain point
            except Exception:
                metrics = None
            try:
                device_counters = self.devctr.counters()
            except Exception:
                device_counters = None
            self.obs.flight.dump(reason=reason, error=error, state=state,
                                 metrics=metrics, device_counters=device_counters)
        except Exception:
            return  # the recorder must not mask the original failure
        if error is not None:
            try:
                error._flightrec_dumped = True
            except Exception:
                pass

    def _note_admitted(self, req: Request, slot: int) -> None:
        req.queue_wait = time.time() - req.submit_t
        self.obs.registry.counter("serve.admitted").inc()
        self.obs.registry.histogram("serve.queue_wait_ms", "submit → admission wall-clock").observe(
            req.queue_wait * 1e3, rid=req.rid)
        self.obs.event("admit", rid=req.rid, slot=slot)

    def _note_first_token(self, req: Request) -> None:
        req.ttft = time.time() - req.submit_t
        self.obs.registry.histogram("serve.ttft_ms", "submit → first sampled token (dispatch)").observe(
            req.ttft * 1e3, rid=req.rid)
        self.obs.event("first_token", rid=req.rid, ttft_ms=req.ttft * 1e3)

    # ---- cache construction ---------------------------------------------
    def _init_caches(self) -> list:
        cfg = self.cfg
        P, dev = cfg.n_periods, self.device
        kh, dh = cfg.n_kv_heads, cfg.head_dim
        dt = DTYPES[cfg.dtype]
        caches = []
        for kind in cfg.layout:
            if kind == "mamba":  # the slots' recurrent states
                caches.append(ssm_mod.init_mamba_state(cfg, self.B, dt, dev, lead=(P,))._asdict())
                continue
            c = {key: torch.zeros((P, 0, self.T, kh, dh), dtype=dt, device=dev) for key in _POOL_KEYS}
            c["pages"] = torch.full((P, self.B, self.book.max_pages), -1, dtype=torch.int32, device=dev)
            if self._extent_mode:  # tuple-of-extents layout (one empty seed)
                for key in _POOL_KEYS:
                    c[key] = (c[key],)
            caches.append(c)
        return caches

    def _attn_slots(self) -> list[dict]:
        """The caches of the attention slots: the only ones with pools and
        page tables."""
        return [c for c, kind in zip(self.caches, self.cfg.layout) if kind == "attn"]

    # ---- pool / page-table management -----------------------------------
    def _grow_pool(self, extra: int, *, count: bool = True) -> None:
        """Add ≥ ``extra`` slabs.  Flat layout: realloc and **copy** the live
        bytes (``pool.copied_bytes``).  Extent layout: append extents."""
        if self._extent_mode:
            from repro_torch.pool import plan_extents

            self._append_extents(plan_extents(tuple(self._extent_sizes), extra, self.grow_chunk),
                                 count=count)
            return
        for c in self._attn_slots():
            for key in _POOL_KEYS:
                pool = c[key]
                self.obs.registry.counter("pool.copied_bytes").inc(pool.numel() * pool.element_size())
                pad = torch.zeros((pool.shape[0], extra, *pool.shape[2:]), dtype=pool.dtype,
                                  device=pool.device)
                c[key] = torch.cat([pool, pad], dim=1)
        self._finish_grow(extra, count=count)

    def _append_extents(self, sizes: list[int], *, count: bool = True) -> None:
        """Zero-copy growth: append fresh extents to every pool tuple."""
        sizes = [s for s in sizes if s > 0]
        if not sizes:
            return
        keep = [j for j, s in enumerate(self._extent_sizes) if s > 0]
        for c in self._attn_slots():
            for key in _POOL_KEYS:
                exts = list(c[key])
                proto = exts[0]
                exts = [exts[j] for j in keep]
                for s in sizes:
                    exts.append(torch.zeros((proto.shape[0], s, *proto.shape[2:]), dtype=proto.dtype,
                                            device=proto.device))
                c[key] = tuple(exts)
        self._extent_sizes = [self._extent_sizes[j] for j in keep] + sizes
        self._finish_grow(sum(sizes), count=count)

    def _finish_grow(self, extra: int, *, count: bool = True) -> None:
        self.book.grow(extra)
        self.free_dev = torch.cat(
            [self.free_dev, torch.ones((extra,), dtype=torch.bool, device=self.device)])
        if count:
            self.obs.registry.counter("pool.grow_events").inc()
            self.obs.registry.counter("pool.grown_slabs").inc(extra)
            self.obs.event("pool_grow", slabs=extra, n_slabs=self.alloc.n_slabs)
        self._sample_live()

    def _grow_for(self, short: int) -> None:
        """Cover a free-list shortfall, sized by the growth schedule;
        reserved-but-unclaimed slabs count as committed demand."""
        from repro_torch.pool import growth_amount, plan_extents

        reserved = self.book.reserved_total
        if self._extent_mode:
            self._append_extents(plan_extents(tuple(self._extent_sizes), short, self.grow_chunk,
                                              reserved=reserved))
            return
        self._grow_pool(growth_amount(self.alloc.n_slabs, short, self.grow_chunk, reserved=reserved))

    def _ensure_table_width(self, need: int) -> None:
        widened = self.book.widen(need)
        if widened is None:
            return
        old, new = widened
        for c in self._attn_slots():
            pad = torch.full((c["pages"].shape[0], self.B, new - old), -1, dtype=torch.int32,
                             device=self.device)
            c["pages"] = torch.cat([c["pages"], pad], dim=-1)

    def _publish_pages(self, slot: int, page0: int, ids: np.ndarray) -> None:
        """Write ``ids`` into ``slot``'s device page rows from page ``page0``."""
        dev_ids = to_device(torch.from_numpy(np.asarray(ids, np.int32)), self.device)
        for c in self._attn_slots():
            c["pages"][:, slot, page0:page0 + len(ids)] = dev_ids

    def _mark(self, ids: np.ndarray, free: bool) -> None:
        """Set the device free bitmap at host ``ids`` (``index_fill_``: an
        indexed assignment of a Python value would copy it from the host
        and synchronise)."""
        if len(ids):
            self.free_dev.index_fill_(0, to_device(torch.from_numpy(np.asarray(ids, np.int64)), self.device),
                                      free)

    def _claim(self, slot: int, k: int) -> np.ndarray:
        """Claim ``k`` slabs for decode slot ``slot`` (reuse-first)."""
        if k == 0:
            return np.zeros((0,), np.int32)
        self._ensure_table_width(int(self.book.npages[slot]) + k)
        short = self.book.shortfall(k)
        if short:
            self._grow_for(short)
        before_reuse = self.alloc.reuse_claims
        ids, page0 = self.book.claim(slot, k)
        self.obs.registry.counter("pool.reused_slabs").inc(self.alloc.reuse_claims - before_reuse)
        self._publish_pages(slot, page0, ids)
        self._mark(ids, False)
        return ids

    def _release(self, slot: int) -> None:
        ids = self.book.release(slot)
        self._mark(ids, True)
        # fill_: assigning a Python value through an index copies it from the
        # host and synchronises
        for c in self._attn_slots():
            c["pages"][:, slot, :].fill_(-1)
        self._len_host[slot] = 0
        self.lengths[slot].fill_(0)
        self.obs.registry.counter("pool.released_slabs").inc(len(ids))
        self._sample_live()

    @property
    def pool_tokens(self) -> int:
        return self.alloc.n_slabs * self.T

    @property
    def live_tokens(self) -> int:
        return int(self._len_host.sum())

    def utilization(self) -> float:
        return self.live_tokens / self.pool_tokens if self.pool_tokens else 0.0

    # ---- request lifecycle ----------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new_tokens,
                      submit_t=time.time())
        self._requests[rid] = req
        self.obs.registry.counter("serve.submitted").inc()
        self.obs.event("submit", rid=rid, prompt_len=len(req.prompt))
        self.sched.submit(rid, len(req.prompt))
        return rid

    def _complete(self, req: Request) -> None:
        req.done = True
        self._release(req.slot)
        self.sched.complete(req.slot)
        self._slots[req.slot] = None
        self.obs.registry.counter("serve.completed").inc()
        if req.generated > 1:
            req.tpot_ms = req.decode_s / (req.generated - 1) * 1e3
            self.obs.registry.histogram("serve.tpot_ms", "mean decode wall-clock per output token").observe(
                req.tpot_ms, rid=req.rid)
        self.obs.event("complete", rid=req.rid, generated=req.generated)

    # ---- chunked admission ----------------------------------------------
    def _ensure_free_slabs(self, short: int) -> bool:
        """Scheduler grow hook: the engine always covers a reservation."""
        self._grow_for(short)
        return True

    def _run_chunk(self, task) -> None:
        """Execute one scheduler ChunkTask: claim → prefill_chunk → advance."""
        req = self._requests[task.rid]
        slot = task.slot
        if task.new_slabs:
            before = self.alloc.reuse_claims
            ids, _ = self.book.claim(slot, task.new_slabs, from_reservation=True)
            self.obs.registry.counter("pool.reused_slabs").inc(self.alloc.reuse_claims - before)
            self._mark(ids, False)
        row = np.full((self.book.max_pages,), -1, np.int32)
        order = self.book.pages_in_order(slot)
        row[: len(order)] = order
        toks = np.zeros((1, task.width), np.int32)
        toks[0, : task.live] = req.prompt[task.t0 : task.t0 + task.live]
        first = task.t0 == 0
        if (task.width, first) not in self._widths:
            self._widths.add((task.width, first))
            self.obs.registry.gauge("serve.prefill_widths", "distinct padded chunk widths").set(
                len(self._widths))
        with self.obs.span("prefill_chunk", rid=task.rid, t0=task.t0, width=task.width):
            logits, self.caches, *ctr = steps.prefill_chunk(
                self.params, to_device(torch.from_numpy(toks), self.device), self.caches, slot,
                task.t0, task.live, to_device(torch.from_numpy(row), self.device), self.cfg,
                first=first,
            )
            if ctr:
                self.devctr.add(ctr[0])
        self.obs.registry.counter("serve.prefill_chunks").inc()
        self.sched.chunk_done(task)
        self._sample_live()
        if task.final:
            self._finish_prefill(req, slot, logits)

    def _finish_prefill(self, req: Request, slot: int, logits) -> None:
        """Final chunk done: publish pages to the device table, arm decode."""
        self._publish_pages(slot, 0, self.book.pages_in_order(slot))
        Lp = len(req.prompt)
        self.lengths[slot].fill_(Lp)
        self._len_host[slot] = Lp
        self.obs.registry.counter("serve.prefills").inc()
        self._sample_live()
        first = sample(None, logits, 0.0)[0]
        req.first_tok = first
        self._note_first_token(req)
        self.cur_tok[slot] = first
        req.admit_step = len(self._stream)
        req.generated = 1
        if req.generated >= req.max_new_tokens:
            self._complete(req)

    # ---- the decode loop -------------------------------------------------
    def _admit_pending(self) -> None:
        from repro_torch.pool import QuotaExceeded

        try:
            admits = self.sched.admit(self._ensure_free_slabs)
        except QuotaExceeded as e:
            self._flight_dump("quota_exceeded", e)
            raise
        for rid, slot, need in admits:
            req = self._requests[rid]
            req.slot = slot
            self._slots[slot] = req
            self._ensure_table_width(need)
            self._note_admitted(req, slot)

    def step(self) -> bool:
        """Admit, run prefill chunks, one batched decode step (interleaved).
        → False when nothing is active.  Any failure inside the step dumps a
        flight-recorder bundle (event ring + engine state + drained
        counters) before the exception propagates — DESIGN.md §9.y."""
        try:
            return self._step_inner()
        except BaseException as e:
            self._flight_dump("step_failure", e)
            raise

    def _step_inner(self) -> bool:
        self._admit_pending()
        tasks = self.sched.next_chunks()
        for task in tasks:
            self._run_chunk(task)
        active = [r for r in self._slots if r is not None and self.sched.phase[r.slot] == "decode"]
        if not active:
            return bool(tasks)
        # claim the next slab before overflow, one growth for the batch
        needy = [r.slot for r in active
                 if self._len_host[r.slot] + 1 > self.book.npages[r.slot] * self.T]
        if needy:
            short = self.book.shortfall(len(needy))
            if short:
                self._grow_for(short)
            for slot in needy:
                self._claim(slot, 1)
        active_mask = None
        if self.sched.prefilling:
            # prefilling slots' Mamba rows must not move (their KV appends
            # already drop through their −1 page rows)
            act = np.zeros((self.B,), bool)
            act[[r.slot for r in active]] = True
            active_mask = to_device(torch.from_numpy(act), self.device)
        step_t0 = time.perf_counter()
        with self.obs.span("decode_step", step=len(self._stream), active=len(active)):
            logits, self.caches, *ctr = steps.decode_step(
                self.params, self.cur_tok, self.caches, self.lengths, self.cfg, active=active_mask)
            if ctr:
                self.devctr.add(ctr[0])  # a list append — no transfer
            sampled = sample(None, logits, 0.0)
        step_dt = time.perf_counter() - step_t0
        self._stream.append(sampled)
        self.cur_tok = sampled.clone()  # admissions write cur_tok in place
        mask = np.zeros((self.B,), np.int32)
        for req in active:
            mask[req.slot] = 1
        self.lengths = self.lengths + to_device(torch.from_numpy(mask), self.device)
        self._len_host += mask
        self.obs.registry.counter("serve.decode_steps").inc()
        self._sample_live()
        stops = None
        if self.stop_token is not None:
            # one (B,) read per step — the price of stop-token scheduling
            stops = self._host_read(sampled, "stop_drain")
        for req in active:
            req.generated += 1
            req.decode_s += step_dt
            hit_stop = stops is not None and stops[req.slot] == self.stop_token
            if req.generated >= req.max_new_tokens or hit_stop:
                self._complete(req)
        return True

    def _has_work(self) -> bool:
        return any(r is not None for r in self._slots) or self.sched.busy

    def run(self) -> dict[int, list[int]]:
        """Drain every submitted request → {rid: prompt + generated tokens}.
        Two device→host reads: the per-request first tokens and the stream."""
        while self._has_work():
            self.step()
        rids = sorted(self._requests)
        firsts = {}
        if rids:
            stack = torch.stack([self._requests[r].first_tok for r in rids])
            firsts = {r: int(v) for r, v in zip(rids, self._host_read(stack, "first_token_drain"))}
        stream = (self._host_read(torch.stack(self._stream), "stream_drain") if self._stream
                  else np.zeros((0, self.B), np.int32))
        out = {}
        for rid in rids:
            req = self._requests[rid]
            lo = req.admit_step
            toks = [firsts[rid]] + [int(t) for t in stream[lo: lo + req.generated - 1, req.slot]]
            out[rid] = list(req.prompt) + toks
        return out

    def run_all(self, prompts: list[list[int]], max_new_tokens: int) -> list[list[int]]:
        """Submit + drain in one call → outputs in prompt order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        out = self.run()
        return [out[r] for r in rids]

    # ---- verification (test/debug only: reads the device) ----------------
    def check_free_list(self) -> None:
        """Device bitmap ⇔ host allocator ⇔ page tables ⇔ refcounts; raises
        ``AssertionError`` on drift, after a flight-recorder bundle that names
        the offending slab ids."""
        try:
            self._check_free_list_inner()
        except AssertionError as e:
            self._flight_dump("engine_invariant", e)  # no-op if already dumped
            raise

    def _violation(self, reason: str, message: str, invariant: dict) -> AssertionError:
        err = AssertionError(message)
        self._flight_dump(reason, err, invariant=invariant)
        return err

    def _check_free_list_inner(self) -> None:
        free = self._host_read(self.free_dev, "free_list_debug")
        if not (free == self.alloc.free).all():
            bad = np.flatnonzero(free != self.alloc.free)
            raise self._violation("free_bitmap_drift", f"device free bitmap drifted: slabs {bad}",
                                  {"check": "free_bitmap", "offending_slabs": bad.tolist()})
        self.alloc.check()
        refs = np.zeros((self.alloc.n_slabs,), np.int64)
        for slot in range(self.B):
            for s in self.book.pages_of[slot]:
                refs[s] += 1
        bad = np.flatnonzero(refs != self.alloc.refcount)
        if len(bad):
            raise self._violation(
                "refcount_mismatch", f"refcounts drift from page tables: {bad}",
                {"check": "refcount_conservation", "offending_slabs": bad.tolist(),
                 "expected_refcount": refs[bad].tolist(),
                 "actual_refcount": np.asarray(self.alloc.refcount)[bad].tolist()})
        bad = np.flatnonzero((refs > 0) == self.alloc.free)
        if len(bad):
            raise self._violation(
                "liveness_drift", f"slab freed while referenced (or live without references): {bad}",
                {"check": "liveness", "offending_slabs": bad.tolist()})
        for c in self._attn_slots():
            pages = self._host_read(c["pages"], "free_list_debug")[0]
            claimed = pages[pages >= 0]
            if len(claimed) and free[claimed].any():
                raise AssertionError("a page table lists a free slab")
            for slot in range(self.B):
                npg = int(self.book.npages[slot])
                row = pages[slot]
                if self.sched.phase[slot] == "prefill":
                    if not (row == -1).all():
                        raise AssertionError(f"slot {slot}: published early")
                else:
                    want = np.asarray(self.book.pages_of[slot], np.int64)
                    if not (row[:npg] == want).all():
                        raise AssertionError(f"slot {slot}: row drift")
                    if not (row[npg:] == -1).all():
                        raise AssertionError(f"slot {slot}: stray pages")
