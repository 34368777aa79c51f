"""Port of the two-phase runtime, mirroring ``tests/runtime/test_phases.py``
and held against the JAX ``TwoPhasePipeline`` on the CPU: grow → freeze →
read → map_frozen → thaw (plain and rebalanced) → regrow → refreeze, the
phase guards, the ``FreezeStats`` counts and the item-shape routing.
Tolerance: none — every comparison is bitwise or an exact count (the one
float function, ``map_frozen``'s ``x * 10.0``, rounds once in both)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import TwoPhasePipeline as RefPipeline
from repro_torch.core import ggarray as gg
from repro_torch.kernels import common
from repro_torch.runtime import FrozenArray, Phase, PhaseError, TwoPhasePipeline


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _waves(seed, steps=5, nblocks=4, mmax=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        m = int(rng.integers(1, mmax))
        out.append((rng.standard_normal((nblocks, m)).astype(np.float32), rng.random((nblocks, m)) < 0.6))
    return out


def _both(waves, host_mask=False, method="scan", **kw):
    ours = TwoPhasePipeline(device="cpu", **kw)
    ref = RefPipeline(**kw)
    for elems, mask in waves:
        p_o = ours.append(torch.from_numpy(elems), mask if host_mask else torch.from_numpy(mask),
                          method=method)
        p_r = ref.append(jnp.asarray(elems), mask if host_mask else jnp.asarray(mask), method=method)
        np.testing.assert_array_equal(p_o.numpy(), np.asarray(p_r))
    return ours, ref


def _assert_frozen_same(fo: FrozenArray, fr):
    np.testing.assert_array_equal(_bits(fo.data), _bits(fr.data))
    assert int(fo.size) == int(fr.size) and fo.size.dtype == torch.int32
    np.testing.assert_array_equal(fo.block_starts.numpy(), np.asarray(fr.block_starts))


@pytest.mark.parametrize("impl", ["segmented", "dispatch", "core"])
@pytest.mark.parametrize("method", ["scan", "auto", "tile", "fused"])
def test_freeze_matches_reference(impl, method):
    ours, ref = _both(_waves(1, mmax=40), method=method, nblocks=4, b0=2, flatten_impl=impl)
    _assert_frozen_same(ours.freeze(), ref.freeze())


def test_whole_lifecycle_matches_reference():
    ours, ref = _both(_waves(2), host_mask=True, nblocks=4, b0=2)
    _assert_frozen_same(ours.freeze(), ref.freeze())
    idx = np.arange(int(ours.frozen.size), dtype=np.int32)[::-1].copy()
    np.testing.assert_array_equal(_bits(ours.read(torch.from_numpy(idx))), _bits(ref.read(jnp.asarray(idx))))
    _assert_frozen_same(ours.map_frozen(lambda x: x * 10.0), ref.map_frozen(lambda x: x * 10.0))
    ours.thaw()
    ref.thaw()
    for elems, mask in _waves(3, steps=3):
        ours.append(torch.from_numpy(elems), torch.from_numpy(mask))
        ref.append(jnp.asarray(elems), jnp.asarray(mask))
    _assert_frozen_same(ours.freeze(), ref.freeze())
    ours.thaw(rebalance=True)
    ref.thaw(rebalance=True)
    np.testing.assert_array_equal(ours.sizes.numpy(), np.asarray(ref.sizes))
    for elems, mask in _waves(4, steps=2):
        ours.append(torch.from_numpy(elems), mask)
        ref.append(jnp.asarray(elems), mask)
    _assert_frozen_same(ours.freeze(), ref.freeze())
    for name in ("appends", "grow_events", "freezes", "thaws", "host_syncs", "elements_frozen"):
        assert getattr(ours.stats, name) == getattr(ref.stats, name), name
    assert ours.total_size() == ref.total_size()
    assert ours.memory_elems() == ref.memory_elems()


def test_phase_guards():
    pipe = TwoPhasePipeline(nblocks=2, b0=2, device="cpu")
    with pytest.raises(PhaseError):
        pipe.thaw()
    with pytest.raises(PhaseError):
        _ = pipe.frozen
    pipe.append(torch.ones((2, 3)))
    pipe.freeze()
    assert pipe.phase is Phase.FROZEN
    with pytest.raises(PhaseError):
        pipe.append(torch.ones((2, 1)))
    with pytest.raises(PhaseError):
        pipe.freeze()
    pipe.thaw()
    assert pipe.phase is Phase.GROW
    with pytest.raises(ValueError):
        TwoPhasePipeline(device="cpu", flatten_impl="nope")
    with pytest.raises(ValueError):
        TwoPhasePipeline(device="cpu", memory_space="smem")


def test_map_frozen_touches_only_live_slots_and_rejects_reshape():
    pipe = TwoPhasePipeline(nblocks=2, b0=2, device="cpu")
    pipe.append(torch.ones((2, 3)))
    n = int(pipe.freeze().size)
    data = pipe.map_frozen(lambda x: x * 10.0).data.numpy()
    np.testing.assert_array_equal(data[:n], 10.0)
    assert not np.any(data[n:])
    with pytest.raises(ValueError):
        pipe.map_frozen(lambda x: x[:1])


def test_frozen_read_matches_read_global():
    pipe = TwoPhasePipeline(nblocks=4, b0=2, device="cpu")
    for elems, mask in _waves(3):
        pipe.append(torch.from_numpy(elems), torch.from_numpy(mask))
    arr = pipe.array
    idx = torch.arange(int(pipe.freeze().size))
    np.testing.assert_array_equal(_bits(pipe.read(idx)), _bits(gg.read_global(arr, idx)))


def test_thaw_rebalance_redistributes_evenly():
    pipe = TwoPhasePipeline(nblocks=4, b0=2, device="cpu")
    mask = np.asarray([[True] * 8] + [[False] * 8] * 3)
    pipe.append(torch.arange(8.0).expand(4, 8), torch.from_numpy(mask))
    pipe.freeze()
    pipe.thaw(rebalance=True)
    sizes = pipe.sizes.numpy()
    assert sizes.sum() == 8 and sizes.max() == 2, sizes


def test_append_loop_is_host_sync_free_and_stats_lazy(monkeypatch):
    """Steady pipeline appends never read the device; freeze stays lazy."""
    pipe = TwoPhasePipeline(nblocks=2, b0=4, nbuckets=4, device="cpu")  # capacity 60/block
    wave = torch.ones((2, 3))
    pipe.append(wave)
    calls = []
    real = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: calls.append(1) or real(self))
    for _ in range(5):
        pipe.append(wave)
    pipe.freeze()
    assert calls == []
    assert pipe.stats.host_syncs == 0 and pipe.stats.freezes == 1
    assert pipe.stats.elements_frozen == 36
    assert len(calls) == 1


def test_from_ggarray_matches_reference_seed_read():
    from repro.core import ggarray as ref_gg

    arr = gg.init(3, 2, nbuckets=2, device="cpu")
    arr, _ = gg.push_back(arr, torch.ones((3, 4)))
    ref_arr, _ = ref_gg.push_back(ref_gg.init(3, 2, nbuckets=2), jnp.ones((3, 4)))
    ours, ref = TwoPhasePipeline.from_ggarray(arr), RefPipeline.from_ggarray(ref_arr)
    assert ours.stats.host_syncs == ref.stats.host_syncs == 1
    _assert_frozen_same(ours.freeze(), ref.freeze())


def test_item_shape_routes_to_core_flatten():
    common.reset_launch_counts()
    ours = TwoPhasePipeline(nblocks=2, b0=2, item_shape=(3,), device="cpu")
    ref = RefPipeline(nblocks=2, b0=2, item_shape=(3,))
    vals = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    ours.append(torch.from_numpy(vals))
    ref.append(jnp.asarray(vals))
    fo, fr = ours.freeze(), ref.freeze()
    assert tuple(fo.data.shape) == (ours.memory_elems(), 3)
    _assert_frozen_same(fo, fr)


@pytest.mark.parametrize("grow_chunk", [1, "doubling", "tz"])
def test_from_arena_lifecycle_matches_reference(grow_chunk):
    """Arena-backed pipelines (``from_arena``): positions, freeze, thaw,
    regrow, refreeze and stats bitwise equal to the JAX package's."""
    from repro.pool import SlabArena as RefArena
    from repro_torch.pool import SlabArena

    ours = TwoPhasePipeline.from_arena(SlabArena(4, 4, grow_chunk=grow_chunk, device="cpu"))
    ref = RefPipeline.from_arena(RefArena(4, 4, dtype=jnp.float32, grow_chunk=grow_chunk))
    for i, (elems, mask) in enumerate(_waves(5, mmax=9)):
        host = i % 2 == 0
        p_o = ours.append(torch.from_numpy(elems), mask if host else torch.from_numpy(mask))
        p_r = ref.append(jnp.asarray(elems), mask if host else jnp.asarray(mask))
        np.testing.assert_array_equal(p_o.numpy(), np.asarray(p_r))
    _assert_frozen_same(ours.freeze(), ref.freeze())
    assert ours.thaw() is ours.arena
    ref.thaw()
    with pytest.raises(PhaseError):
        ours.array
    for elems, mask in _waves(6, steps=2):
        ours.append(torch.from_numpy(elems), mask)
        ref.append(jnp.asarray(elems), mask)
    _assert_frozen_same(ours.freeze(), ref.freeze())
    with pytest.raises(PhaseError, match="rebalance"):
        ours.thaw(rebalance=True)
    for name in ("appends", "grow_events", "freezes", "thaws", "host_syncs", "elements_frozen"):
        assert getattr(ours.stats, name) == getattr(ref.stats, name), name
    assert ours.total_size() == ref.total_size()
    assert ours.memory_elems() == ref.memory_elems()
    assert ours.nblocks == ref.nblocks == 4
    np.testing.assert_array_equal(ours.sizes.numpy(), np.asarray(ref.sizes))


def test_ggarray_pipeline_has_no_arena():
    pipe = TwoPhasePipeline(nblocks=2, b0=2, device="cpu")
    with pytest.raises(PhaseError):
        pipe.arena
