"""Port of copy-on-write prefix caching (``repro.serving.prefix`` and
``BatchEngine(prefix_cache=True)``), as in ``tests/serving/
test_prefix_cache.py``:

* the host trie: the port's ``block_hash`` equals the reference's; publish /
  match round trip, a truncated-hash collision that never aliases the wrong
  slab, LRU eviction of leaves and its cascade, eviction skipping slabs a
  page table still holds;
* refcount conservation over interleaved submit / append (with its
  copy-on-write) / complete / evict, scripted and as a property: the port's
  page tables, refcounts, free list, trie contents and evicted ids equal
  the reference's after every event (bitwise: host integers);
* the engine, on ``reduced("qwen2.5-3b", cache_b0=4)`` with the reference's
  own parameters: a shared-prefix fleet token for token equal to a cold
  run and to the reference's warm run, with the same prefix hits, reused
  tokens, copy-on-write copies, prefill chunks and final refcounts; extent
  pools grow with zero bytes copied; ``prefix_cache`` refuses monolithic
  admission and Mamba layouts with ``ValueError``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:  # property tests skip, example tests still run
    from _hypothesis_fallback import given, settings, st

from repro import configs as rconfigs
from repro.models import transformer as rtf
from repro.pool import PageBook as RPageBook
from repro.serving import prefix as rprefix
from repro.serving.engine import BatchEngine as RBatchEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as tf
from repro_torch.pool import PageBook
from repro_torch.serving import prefix
from repro_torch.serving.engine import BatchEngine

PACKAGES = {"port": (PageBook, prefix), "reference": (RPageBook, rprefix)}


# ---------------------------------------------------------------- the trie
def _book(n=16, ntenants=4, pkg="port"):
    book = PACKAGES[pkg][0](ntenants)
    book.grow(n)
    return book


def test_block_hash_matches_reference():
    rng = np.random.default_rng(0)
    for bits in (6, 8, 24, 63):
        for n in (0, 1, 4, 2048):
            block = tuple(int(t) for t in rng.integers(0, 151936, n))
            assert prefix.block_hash(block, bits) == rprefix.block_hash(block, bits)


def test_publish_match_roundtrip():
    book = _book()
    px = prefix.PrefixCache(book.alloc, slab_tokens=4)
    prompt = list(range(1, 11))  # two full blocks + a 2-token partial tail
    ids, _ = book.claim(0, 3)
    assert px.publish(prompt, book.pages_of[0]) == 2  # a partial block is never cached
    blocks, got = px.match(prompt)
    assert blocks == 2 and list(got) == [int(ids[0]), int(ids[1])]
    blocks, got = px.match(list(range(1, 5)))
    assert blocks == 1 and got[0] == ids[0]
    assert px.match([1, 2, 3, 4, 9, 9, 9, 9])[0] == 1  # diverges at block 2
    assert px.match([9, 9, 9, 9])[0] == 0  # a cold miss
    book.release(0)
    assert book.alloc.refcount[ids[0]] == 1, "the trie keeps cached slabs alive"
    assert book.alloc.free[ids[2]], "the uncached tail is freed with its owner"
    book.alloc.check()


def _collide(bits=8, head=(7, 7, 7)):
    """Two distinct blocks with equal truncated hashes (birthday search)."""
    seen = {}
    for x in range(1 << 16):
        blk = head + (x,)
        h = prefix.block_hash(blk, bits)
        if h in seen:
            return seen[h], blk
        seen[h] = blk
    raise AssertionError("no collision found")


def test_hash_collision_never_aliases_wrong_slab():
    a, b = _collide()
    assert a != b and prefix.block_hash(a, 8) == prefix.block_hash(b, 8)
    book = _book()
    px = prefix.PrefixCache(book.alloc, slab_tokens=4, hash_bits=8)
    ids_a, _ = book.claim(0, 1)
    px.publish(list(a), book.pages_of[0])
    blocks, got = px.match(list(b))
    assert blocks == 0 and len(got) == 0, "a colliding block served the wrong slab"
    ids_b, _ = book.claim(1, 1)  # both blocks live under one edge key
    px.publish(list(b), book.pages_of[1])
    assert px.match(list(a))[1][0] == ids_a[0]
    assert px.match(list(b))[1][0] == ids_b[0]


def test_lru_eviction_prefers_cold_leaves_and_cascades():
    book = _book()
    px = prefix.PrefixCache(book.alloc, slab_tokens=2)
    book.claim(0, 2)
    px.publish([1, 2, 3, 4], book.pages_of[0])
    chain = list(book.pages_of[0])
    book.release(0)
    book.claim(1, 1)
    px.publish([9, 9], book.pages_of[1])
    cold = list(book.pages_of[1])
    book.release(1)
    px.match([1, 2, 3, 4])  # touch the chain: the lone block is the coldest
    assert list(px.evict(1)) == cold
    # the interior node goes only after its leaf: a cascade
    assert set(int(s) for s in px.evict(2)) == set(chain)
    assert len(px) == 0 and book.alloc.live_count == 0
    book.alloc.check()


def test_evict_skips_referenced_slabs():
    book = _book()
    px = prefix.PrefixCache(book.alloc, slab_tokens=2)
    book.claim(0, 1)
    px.publish([5, 6], book.pages_of[0])
    assert len(px.evict(5)) == 0, "a tenant still aliases the slab"
    book.release(0)
    assert len(px.evict(5)) == 1


# ------------------------------------------------- refcount conservation
T = 4
PREFIXES = [
    tuple(range(10, 10 + 2 * T)),  # two blocks
    tuple(range(10, 10 + 3 * T)),  # extends the first (a shared trie path)
    tuple(range(90, 90 + T)),  # disjoint
]


class _Sim:
    """The engine's host bookkeeping without a model — PageBook,
    PrefixCache and a shadow of every slab's tokens — over one package.
    ``check`` asserts the invariants after every event: page-table and
    trie references sum to each refcount, a slab is free iff nothing
    references it, and every cached slab still holds the tokens it was
    published with (copy-on-write never mutated it)."""

    def __init__(self, pkg, ntenants=3):
        book_cls, mod = PACKAGES[pkg]
        self.book = book_cls(ntenants)
        self.alloc = self.book.alloc
        self.px = mod.PrefixCache(self.alloc, slab_tokens=T, hash_bits=6)
        self.data = {}  # slab id → tokens written into it
        self.seq = {}  # busy tenant → its sequence so far
        self.N = ntenants
        self.cows = 0
        self.evicted = []

    def _grow(self, k):
        short = self.book.shortfall(k)
        if short:
            self.book.grow(short)

    def submit(self, tenant, pidx, suffix):
        if tenant in self.seq:
            return
        prompt = list(PREFIXES[pidx % len(PREFIXES)]) + [200 + s for s in range(suffix)]
        blocks, ids = self.px.match(prompt)
        self.alloc.addref(ids)  # the pin of an admission
        for j, s in enumerate(ids):
            assert self.data[int(s)] == prompt[j * T:(j + 1) * T]
        self.book.adopt(tenant, ids)
        need = max(-(-len(prompt) // T), 1) - blocks
        self._grow(need)
        fresh, _ = self.book.claim(tenant, need)
        for j, s in zip(range(blocks, blocks + need), fresh):
            self.data[int(s)] = prompt[j * T:(j + 1) * T]
        if blocks * T >= len(prompt):  # a full hit rewrites the last prompt token
            prompt = prompt[:-1]
        self.seq[tenant] = prompt

    def append(self, tenant, tok):
        if tenant not in self.seq:
            return
        pos = len(self.seq[tenant])
        page = pos // T
        if page >= int(self.book.npages[tenant]):
            self._grow(1)
            (s,), _ = self.book.claim(tenant, 1)
            self.data[int(s)] = []
        slab = self.book.pages_of[tenant][page]
        if int(self.alloc.refcount[slab]) > 1:  # copy-on-write
            self._grow(1)
            new = int(self.alloc.claim(tenant, 1)[0])
            self.book.replace(tenant, page, new)
            self.data[new] = list(self.data[slab])
            self.alloc.release(np.asarray([slab], np.int32), tenant=tenant)
            self.cows += 1
            slab = new
        self.data[slab] = self.data[slab][:pos % T] + [tok]
        self.seq[tenant].append(tok)

    def complete(self, tenant):
        if tenant not in self.seq:
            return
        self.px.publish(self.seq[tenant], self.book.pages_of[tenant])
        for f in self.book.release(tenant):
            self.data.pop(int(f))
        del self.seq[tenant]

    def evict(self, k):
        freed = [int(f) for f in self.px.evict(k)]
        self.evicted.append(freed)
        for f in freed:
            self.data.pop(f)

    def check(self):
        self.alloc.check()
        refs = np.zeros((self.alloc.n_slabs,), np.int64)
        for t in range(self.N):
            for s in self.book.pages_of[t]:
                refs[s] += 1
        for s in self.px.cached_slabs():
            refs[s] += 1
        assert (refs == self.alloc.refcount).all(), "refcount conservation"
        assert ((refs > 0) == ~self.alloc.free).all(), "a slab freed while referenced"
        for node in self.px._lru:  # cached data never mutates
            assert tuple(self.data[node.slab][:len(node.tokens)]) == node.tokens

    def state(self):
        return (list(map(list, self.book.pages_of)), np.asarray(self.alloc.refcount).tolist(),
                np.asarray(self.alloc.free).tolist(), self.px.cached_slabs(), self.evicted, self.cows)


def _run_ops(ops):
    """The ops on the port's bookkeeping and the reference's, in lockstep:
    invariants after every event, equal states after every event."""
    sims = [_Sim("port"), _Sim("reference")]
    for kind, t, v in ops:
        for sim in sims:
            t_ = t % sim.N
            if kind == 0:
                sim.submit(t_, v, v % 3)
            elif kind == 1:
                sim.append(t_, 300 + v)
            elif kind == 2:
                sim.complete(t_)
            else:
                sim.evict(v % 4 + 1)
            sim.check()
        assert sims[0].state() == sims[1].state()
    for t in list(sims[0].seq):
        for sim in sims:
            sim.complete(t)
            sim.check()
    assert sims[0].state() == sims[1].state()
    return sims[0]


def test_refcount_conservation_scripted():
    """Cold fill, publish, a full hit with its copy-on-write rewrite, a
    partial hit along the shared path, eviction under pressure."""
    sim = _run_ops([
        (0, 0, 1), (1, 0, 1), (2, 0, 0),  # cold: prefix 1 + a 1-token tail; publish 3 blocks
        (0, 1, 0), (1, 1, 5),  # a full hit on prefix 1; its rewrite lands in a shared slab
        (0, 2, 3), (1, 2, 6),  # a partial hit: 2 blocks along the shared path
        (3, 0, 2), (2, 1, 0), (2, 2, 0), (3, 0, 9),
    ])
    assert sim.cows >= 1, "the full hit's rewrite never copied"


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 2), st.integers(0, 40)), max_size=60))
def test_refcount_conservation_property(ops):
    """Interleaved submit / append / complete / evict (derandomised draws):
    conservation holds, no referenced slab is freed, no shared slab
    mutates, and the port's bookkeeping equals the reference's."""
    _run_ops(ops)


@pytest.mark.parametrize("seed", range(4))
def test_refcount_conservation_seeded(seed):
    """The property test's seeded twin: runs without hypothesis too."""
    rng = np.random.default_rng(seed)
    _run_ops([(int(a), int(b), int(c)) for a, b, c in zip(
        rng.integers(0, 4, 60), rng.integers(0, 3, 60), rng.integers(0, 41, 60))])


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def model():
    rcfg = rconfigs.reduced("qwen2.5-3b", cache_b0=4)
    cfg = configs.reduced("qwen2.5-3b", cache_b0=4)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


def _warm(make, params, cfg, prompts, new, **kw):
    """Serve ``prompts[0]`` alone (its completion publishes the prefix),
    then the rest → (outputs in order, the engine)."""
    be = make(params, cfg, prefix_cache=True, **kw)
    r0 = be.submit(prompts[0], new)
    first = be.run()[r0]
    rids = [be.submit(p, new) for p in prompts[1:]]
    out = be.run()
    return [first] + [out[r] for r in rids], be


@pytest.mark.parametrize("impl", ["levels", "pallas"])
def test_prefix_cache_bit_exact_and_skips_prefill(model, impl):
    """A shared-prefix fleet: tokens equal to a cold run's, zero prefill
    chunks for the fully cached duplicate, one for each uncached suffix, at
    least one copy-on-write, the prefix stored once; tokens, hits, reused
    tokens, copies, chunks and refcounts equal to the reference's warm run.
    ``"pallas"``: the decode over the aliased pages runs K10's wrapper
    (its plain version on the CPU)."""
    rcfg, cfg, rparams, params = model
    rcfg = dataclasses.replace(rcfg, paged_attend_impl=impl)
    cfg = dataclasses.replace(cfg, paged_attend_impl=impl)
    base = [int(t) for t in np.random.default_rng(2).integers(1, 50, 36)]
    prompts = [base, base + [3, 1], base + [7, 7, 7, 2, 9], base]
    cold = BatchEngine(params, cfg, max_batch=4, device="cpu")
    want = cold.run_all(prompts, 4)
    got, warm = _warm(BatchEngine, params, cfg, prompts, 4, max_batch=4, device="cpu")
    assert got == want, "prefix reuse changed a sampled token"
    st = warm.stats
    assert (st.prefix_hits, st.prefix_tokens_reused) == (3, 3 * len(base))
    assert st.prefill_chunks == 2 + 2  # 36 tokens cold: 2 chunks; the suffixes 1 each; the duplicate 0
    assert st.cow_copies >= 1, "the full hit decoded into a shared slab"
    assert warm.alloc.n_slabs < cold.alloc.n_slabs, "the prefix is stored once"
    events = warm.obs.tracer.events
    assert sum(e["name"] == "prefix_hit" and e["attrs"]["full"] for e in events) == 1
    firsts = [e["attrs"]["rid"] for e in events if e["name"] == "first_token"]
    assert sorted(firsts) == [0, 1, 2, 3], "every request records TTFT once (a full hit at its first decode)"
    warm.check_free_list()
    rgot, ref = _warm(RBatchEngine, rparams, rcfg, prompts, 4, max_batch=4)
    assert rgot == got
    rs = ref.stats
    assert (st.prefix_hits, st.prefix_tokens_reused, st.cow_copies, st.prefill_chunks) == (
        rs.prefix_hits, rs.prefix_tokens_reused, rs.cow_copies, rs.prefill_chunks)
    np.testing.assert_array_equal(warm.alloc.refcount, ref.alloc.refcount)
    assert warm.prefix.cached_slabs() == ref.prefix.cached_slabs()
    ours, theirs = warm._flightrec_state(), ref._flightrec_state()
    assert (ours["prefix"], ours["pinned"], ours["admission"]) == (
        theirs["prefix"], theirs["pinned"], theirs["admission"])


def test_prefix_cache_with_extent_pool_zero_copy(model):
    """Aliasing over extents: the copy-on-write copies one slab inside the
    extents, and growth never copies the pool."""
    _, cfg, _, params = model
    base = [int(t) for t in np.random.default_rng(5).integers(1, 50, 8)]
    prompts = [base, base + [2, 4], base]
    want = BatchEngine(params, cfg, max_batch=2, device="cpu").run_all(prompts, 3)
    got, be = _warm(BatchEngine, params, cfg, prompts, 3, max_batch=2, grow_chunk="doubling",
                    device="cpu")
    assert got == want
    assert be.stats.prefix_hits == 2 and be.stats.cow_copies >= 1
    assert be.stats.pool_copied_bytes == 0, "extent growth must never copy"
    be.check_free_list()


def test_prefix_cache_evicts_under_pool_pressure(model):
    """A quota-free fleet whose cached slabs are evicted when the free list
    runs short: the pool grows less than without eviction, and the
    refcounts still balance."""
    _, cfg, _, params = model
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(1, 50, 8)] for _ in range(4)]
    be = BatchEngine(params, cfg, max_batch=1, prefix_cache=True, device="cpu")
    for p in prompts:  # one at a time: each completion publishes 2 slabs
        be.run_all([p], 2)
    assert be.obs.registry.counter("serve.prefix_evicted").total() > 0
    be.check_free_list()
    assert be.alloc.n_slabs < 2 * len(prompts) + 1


def test_prefix_cache_requires_chunked_attention(model):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="chunked"):
        BatchEngine(params, cfg, admission="monolithic", prefix_cache=True, device="cpu")
    hcfg = configs.reduced("jamba-v0.1-52b", cache_b0=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    hparams = tf.init_params(hcfg, gen)
    with pytest.raises(ValueError, match="attention-only"):
        BatchEngine(hparams, hcfg, prefix_cache=True, device="cpu")
