"""Port of the token packer (``repro.data.packing``), mirroring
``tests/data/test_packing.py`` and held against the JAX ``Packer``: the same
documents give identical packs (tokens and loss masks, bitwise) from both
packages and from both backends, ``"pipeline"`` and ``"arena"``, with the
same planner host-sync counts — zero per document on the arena."""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro.data.packing import Packer as RefPacker
from repro_torch.data import Packer


def test_pack_preserves_all_tokens():
    p = Packer(nblocks=2, b0=4, device="cpu")
    docs = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10]]
    for d in docs:
        p.add_document(d)
    assert p.total_tokens == sum(len(d) for d in docs)
    out = p.pack(batch=2, seq=8, pad_id=0)
    got = sorted(out["tokens"].reshape(-1)[out["loss_mask"].reshape(-1)].tolist())
    assert got == sorted(t for d in docs for t in d)


def test_blocks_stay_balanced():
    p = Packer(nblocks=4, b0=4, device="cpu")
    for i in range(12):
        p.add_document([i] * 5)
    sizes = p.sizes.numpy()
    assert sizes.max() - sizes.min() <= 5


@given(st.lists(st.integers(1, 12), min_size=1, max_size=10), st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_property_token_conservation(doc_lens, seed):
    rng = np.random.default_rng(seed)
    p = Packer(nblocks=2, b0=4, backend="arena", device="cpu")
    all_tokens = []
    for n in doc_lens:
        doc = rng.integers(1, 1000, n).tolist()
        all_tokens += doc
        p.add_document(doc)
    total = len(all_tokens)
    got = p.pack(batch=1, seq=max(total, 1))["tokens"].reshape(-1)[:total]
    assert sorted(got.tolist()) == sorted(all_tokens)


@pytest.mark.parametrize("backend", ["pipeline", "arena"])
def test_packs_match_reference(backend):
    """Both packages, same documents → the same packs, before and after a
    thaw, and the same stats."""
    rng = np.random.default_rng(11)
    docs = [rng.integers(1, 500, int(rng.integers(1, 30))).tolist() for _ in range(16)]
    ours = Packer(nblocks=4, b0=16, backend=backend, device="cpu")
    theirs = RefPacker(nblocks=4, b0=16, backend=backend)
    for round_ in range(2):
        for d in docs[round_ * 8:(round_ + 1) * 8]:
            ours.add_document(d)
            theirs.add_document(d)
        po, pr = ours.pack(batch=4, seq=40), theirs.pack(batch=4, seq=40)
        for k in ("tokens", "loss_mask"):
            np.testing.assert_array_equal(po[k].numpy(), np.asarray(pr[k]), err_msg=k)
        assert po["tokens"].dtype == torch.int32 and po["loss_mask"].dtype == torch.bool
    np.testing.assert_array_equal(ours.sizes.numpy(), np.asarray(theirs.sizes))
    for name in ("appends", "grow_events", "freezes", "thaws", "host_syncs"):
        assert getattr(ours.stats, name) == getattr(theirs.stats, name), name
    assert ours.total_tokens == theirs.total_tokens


def test_arena_backend_matches_pipeline_backend():
    rng = np.random.default_rng(11)
    docs = [rng.integers(1, 500, int(rng.integers(1, 30))).tolist() for _ in range(20)]
    outs = {}
    for backend in ("pipeline", "arena"):
        p = Packer(nblocks=4, b0=16, backend=backend, device="cpu")
        for d in docs:
            p.add_document(d)
        outs[backend] = p.pack(batch=4, seq=48)
        p.add_document([1, 2, 3])  # ingestion resumes after pack (thaw)
        assert p.total_tokens == sum(map(len, docs)) + 3
    for k in ("tokens", "loss_mask"):
        np.testing.assert_array_equal(outs["pipeline"][k].numpy(), outs["arena"][k].numpy())


def test_arena_backend_is_sync_free():
    p = Packer(nblocks=4, b0=16, backend="arena", device="cpu")
    for i in range(10):
        p.add_document([i] * 7)
    assert p.stats.host_syncs == 0


def test_unknown_backend_and_default_device():
    with pytest.raises(ValueError):
        Packer(backend="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Packer()
