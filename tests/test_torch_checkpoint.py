"""Port of checkpointing (``repro.checkpoint.ckpt``): the on-disk format is
the reference's (``step_%08d/``, ``manifest.json``, one ``.npy`` a leaf,
the same keys in the same order), so checkpoints cross between the
packages.  Every comparison here is bitwise."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint import ckpt as rckpt
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.convert import tensor_to_numpy, train_state_from_numpy, train_state_to_numpy
from repro_torch.train import step as tstep
from repro_torch.tree import leaves

ARCH = "qwen1.5-0.5b"


def _bits(a) -> np.ndarray:
    a = tensor_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
        a = a.view(np.uint16)
    return a


def _same_leaves(ours, theirs) -> None:
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _ref_state(dtype="float32", compression=False):
    rcfg = rconfigs.reduced(ARCH, n_layers=2, dtype=dtype, param_dtype=dtype)
    cfg = configs.reduced(ARCH, n_layers=2, dtype=dtype, param_dtype=dtype)
    rstate = rstep.init_train_state(jax.random.PRNGKey(0), rcfg, grad_compression=compression)
    return cfg, rstate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip_is_exact(tmp_path, dtype):
    cfg = configs.reduced(ARCH, n_layers=2, dtype=dtype, param_dtype=dtype)
    state = tstep.init_train_state(0, cfg, grad_compression=True, device="cpu")
    with torch.no_grad():  # a non-zero step and moments
        state.opt.step.fill_(7)
        for m in leaves(state.opt.m):
            m.normal_()
    path = ckpt.save(str(tmp_path), 7, state, metadata={"next_step": 7})
    assert os.path.basename(path) == "step_00000007"
    restored, meta = ckpt.restore(str(tmp_path), 7, state)
    assert meta == {"next_step": 7}
    assert type(restored) is type(state) and restored.ef is not None
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.requires_grad == b.requires_grad
        assert a is not b
    _same_leaves(leaves(restored), leaves(state))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    dtypes = {e["dtype"] for e in manifest["leaves"]}
    assert dtypes == ({"float32", "int32"} if dtype == "float32" else {"bfloat16", "float32", "int32"})
    if dtype == "bfloat16":  # stored as uint16 bits
        first = manifest["leaves"][0]
        assert first["dtype"] == "bfloat16"
        assert np.load(os.path.join(path, first["file"])).dtype == np.uint16


def test_partial_tmp_dir_is_ignored(tmp_path):
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    cfg = configs.reduced(ARCH, n_layers=2)
    state = tstep.init_train_state(0, cfg, device="cpu")
    ckpt.save(str(tmp_path), 3, state.params)
    (tmp_path / "step_00000012.tmp").mkdir()
    (tmp_path / "step_00000011").mkdir()  # no manifest: incomplete
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_leaf_count_mismatch_raises(tmp_path):
    cfg = configs.reduced(ARCH, n_layers=2)
    state = tstep.init_train_state(0, cfg, device="cpu")
    ckpt.save(str(tmp_path), 1, state.params)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, state)


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    """f32, with an error-feedback residual: every leaf bitwise."""
    cfg, rstate = _ref_state(compression=True)
    rckpt.save(str(tmp_path), 5, rstate, metadata={"next_step": 5})
    like = tstep.init_train_state(1, cfg, grad_compression=True, device="cpu")
    restored, meta = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)), like)
    assert meta == {"next_step": 5}
    _same_leaves(leaves(restored), jax.tree.leaves(rstate))
    assert all(p.requires_grad for p in leaves(restored.params))


def test_port_checkpoint_restored_by_the_reference(tmp_path):
    cfg, rstate = _ref_state()
    state = tstep.init_train_state(2, cfg, device="cpu")
    ckpt.save(str(tmp_path), 4, state, metadata={"next_step": 4})
    assert rckpt.latest_step(str(tmp_path)) == 4
    restored, meta = rckpt.restore(str(tmp_path), 4, rstate)
    assert meta == {"next_step": 4}
    _same_leaves(leaves(state), jax.tree.leaves(restored))


def test_reference_bf16_checkpoint_read_by_the_port(tmp_path):
    """``np.save`` writes the reference's bf16 leaves as ``|V2``; the port
    reads them back as torch.bfloat16, bit for bit."""
    cfg, rstate = _ref_state("bfloat16")
    rckpt.save(str(tmp_path), 2, rstate)
    manifest = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    e = next(e for e in manifest["leaves"] if e["dtype"] == "bfloat16")
    assert np.load(tmp_path / "step_00000002" / e["file"]).dtype.str == "|V2"
    like = tstep.init_train_state(1, cfg, device="cpu")
    restored, _ = ckpt.restore(str(tmp_path), 2, like)
    assert [p.dtype for p in leaves(restored)] == [p.dtype for p in leaves(like)]
    assert torch.bfloat16 in {p.dtype for p in leaves(restored)}
    _same_leaves(leaves(restored), jax.tree.leaves(rstate))


def test_keys_match_the_reference_manifest(tmp_path):
    cfg, rstate = _ref_state(compression=True)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate), "cpu")
    rckpt.save(str(tmp_path / "ref"), 1, rstate)
    ckpt.save(str(tmp_path / "port"), 1, state)
    ref = json.load(open(tmp_path / "ref" / "step_00000001" / "manifest.json"))
    ours = json.load(open(tmp_path / "port" / "step_00000001" / "manifest.json"))
    assert ours == ref
    keys = [e["key"] for e in ours["leaves"]]
    assert keys[:3] == [".params/embed", ".params/final_norm", ".params/layers/0/attn/bk"]
    # params, the step and two moments of 14 leaves each, the residual's 14
    assert len(keys) == len(jax.tree.leaves(rstate)) == 14 + 1 + 2 * 14 + 14
    back = train_state_to_numpy(state)
    _same_leaves(leaves(back), jax.tree.leaves(rstate))


def test_save_async_snapshots_before_returning(tmp_path):
    """The port updates in place: an update right after ``save_async``
    returns must not reach the checkpoint."""
    cfg = configs.reduced(ARCH, n_layers=2)
    state = tstep.init_train_state(0, cfg, device="cpu")
    before = [p.detach().clone() for p in leaves(state)]
    ckpt.save_async(str(tmp_path), 1, state, metadata={"next_step": 1})
    with torch.no_grad():
        for p in leaves(state.params):
            p.add_(1.0)
        state.opt.step.add_(3)
    ckpt.wait_pending()
    restored, meta = ckpt.restore(str(tmp_path), 1, state)
    assert meta == {"next_step": 1}
    _same_leaves(leaves(restored), before)
