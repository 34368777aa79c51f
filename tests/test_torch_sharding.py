"""Port of the sharding rules (``repro.distributed``, ``repro.launch.mesh``):
every ``ARCH_NAMES`` config at full width, on meshes from one device to a
two-pod production mesh, gives the reference's logical rules and the
reference's parameter, batch and cache specs entry for entry.

Both packages read only a mesh's axis names and sizes, so both get the
same shape-only mesh.  The reference's trees are ``jax.eval_shape``
structs; the port's are ``meta`` tensors of the same shapes (its parameter
tree has the reference's structure, leaf for leaf; its decode caches are
its own ``init_decode_caches`` on ``meta``).
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.distributed import context as rcontext
from repro.distributed import sharding as rsh
from repro.models import transformer as rtransformer
from repro.serving import steps as rsteps
from repro_torch import configs
from repro_torch.distributed import context, sharding as sh
from repro_torch.serving import steps
from repro_torch.tree import leaves, paths

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x4": {"data": 2, "model": 4},
    "4x2": {"data": 4, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
BATCHES = (1, 3, 16, 32, 256)
CACHE_BATCH, CACHE_LEN, ENC_LEN = 32, 256, 64


def _mesh(name: str):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = rconfigs.get(arch)
    return jax.eval_shape(lambda k: rtransformer.init_params(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_caches(arch: str):
    cfg = rconfigs.get(arch)
    enc = ENC_LEN if cfg.n_enc_layers else None
    return jax.eval_shape(lambda: rsteps.init_decode_caches(cfg, CACHE_BATCH, CACHE_LEN, enc_len=enc))


def _meta(tree):
    """A reference shape tree → the same structure of ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tree.shape, dtype=torch.float32, device="meta")


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _same_specs(ours, theirs) -> None:
    theirs = _ref_leaves(theirs)
    ours = paths(ours)
    assert len(ours) == len(theirs)
    for (key, a), (path, b) in zip(ours, theirs):
        assert isinstance(a, sh.PartitionSpec), key
        assert tuple(a) == tuple(b), (key, jax.tree_util.keystr(path), a, b)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_rules_and_specs_match_the_reference(arch, mesh):
    cfg, rcfg, m = configs.get(arch), rconfigs.get(arch), _mesh(mesh)
    assert sh.logical_rules(cfg, m) == rsh.logical_rules(rcfg, m)
    assert sh.data_axes(m) == rsh.data_axes(m)

    rparams = _ref_params(arch)
    ours = sh.param_specs(_meta(rparams), cfg, m)
    _same_specs(ours, rsh.param_specs(rparams, rcfg, m))

    for b in BATCHES:
        got, want = sh.batch_specs(cfg, m, b), rsh.batch_specs(rcfg, m, b)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}

    rcaches = _ref_caches(arch)
    enc = ENC_LEN if cfg.n_enc_layers else None
    caches = steps.init_decode_caches(cfg, CACHE_BATCH, CACHE_LEN, enc_len=enc, device="meta")
    assert [tuple(t.shape) for t in leaves(caches)] == [tuple(s.shape) for s in jax.tree.leaves(rcaches)]
    _same_specs(sh.cache_specs(caches, cfg, m), rsh.cache_specs(rcaches, rcfg, m))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_constraints_resolve_as_the_reference(mesh):
    """``constrain``'s name → axes resolution (with its divisibility
    fallback) against the reference's, read off its PartitionSpec."""
    m = _mesh(mesh)
    cases = [((32, 4096, 64), ("batch", "seq", None)), ((3, 4096, 64), ("batch", "seq", None)),
             ((32, 5, 64), ("batch", None, "vocab")), ((16, 64, 24, 128), ("batch", None, "heads", None)),
             ((256, 16, 8), ("tokens", "experts", "expert_cap")), ((512, 7), ("expert_slots", None)),
             ((4, 8, 2, 2, 16), ("batch", "seq", None, None, None))]
    seen = []

    def spy(x, sharding):
        seen.append(tuple(sharding.spec))
        return x

    real = (jax.lax.with_sharding_constraint, rcontext.NamedSharding)
    rcontext.NamedSharding = lambda mesh_, spec: types.SimpleNamespace(spec=spec)
    jax.lax.with_sharding_constraint = spy
    try:
        with rcontext.activation_mesh(m):
            for shape, axes in cases:
                rcontext.constrain(np.zeros(shape, np.float32), axes)
    finally:
        jax.lax.with_sharding_constraint, rcontext.NamedSharding = real
    assert [context.logical_spec(shape, axes, m) for shape, axes in cases] == seen


def test_constrain_is_the_identity_without_a_mesh_and_on_plain_tensors():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert context.active_mesh() is None
    assert context.constrain(x, ("batch", "seq", None)) is x
    tree = {"a": x, "b": [x[0]]}
    assert context.constrain_tree(tree, {"a": sh.P(None), "b": [sh.P()]}) is tree
    assert sh.constrain_param_tree(tree, configs.reduced("qwen2.5-3b")) is tree
    with context.activation_mesh(_mesh("2x4")):  # a mesh, but a plain tensor
        assert context.active_mesh() is not None
        assert context.constrain(x, ("batch", "seq", None)) is x
        out = context.constrain_tree(tree, {"a": sh.P("data"), "b": [sh.P()]})
        assert out["a"] is x and out["b"][0] is tree["b"][0]
    assert context.active_mesh() is None


def test_placements_put_the_first_axis_of_a_tuple_major():
    from torch.distributed.tensor import Replicate, Shard

    m = _mesh("2x16x16")
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m) == [Shard(0), Shard(0), Shard(2)]
    assert sh.placements(sh.P(), m) == [Replicate()] * 3
    # a size-1 mesh dim holds the whole dim: replicated
    assert sh.placements(sh.P("data", "model"), _mesh("1x1")) == [Replicate()] * 2
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(sh.P(("model", "data")), m)


def test_partition_spec_is_a_leaf():
    spec = sh.P(("pod", "data"), None)
    assert tuple(spec) == (("pod", "data"), None) and spec == (("pod", "data"), None)
    assert leaves({"w": spec, "b": sh.P()}) == [sh.P(), spec]


def test_mesh_needs_a_card_unless_asked_for_cpu_and_a_process_group():
    from repro_torch.launch import mesh as mesh_mod

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_mod.make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_mod.make_production_mesh()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 1 ranks"):
        mesh_mod.make_host_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group of 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
