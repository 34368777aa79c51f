"""Port of the fault-tolerant loop (``repro.train.loop``) and the training
launcher (``repro.launch.train``), on the CPU: mirrors of
``tests/train/test_loop_fault_tolerance.py`` (a crash, then a resume whose
losses are bitwise the uninterrupted run's; async checkpoints; compressed
gradients that still converge), straggler counting, and the launcher's
``main``.  The reference's PRNG does not carry over, so these hold the
port to itself; the parity of each piece with the reference is in
``test_torch_{optim,train_step,checkpoint}.py``."""
import numpy as np
import pytest

from repro_torch.checkpoint import ckpt
from repro_torch.configs import reduced
from repro_torch.launch import train as launch_train
from repro_torch.train import loop as loop_mod

CFG = reduced("qwen1.5-0.5b", n_layers=2)


def _loop(tmp, **kw):
    base = dict(steps=8, batch=2, seq=16, ckpt_dir=tmp, ckpt_every=3, log_every=100)
    base.update(kw)
    return loop_mod.LoopConfig(**base)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_crash_resume_matches_uninterrupted(tmp_path, async_ckpt):
    ref = loop_mod.run(CFG, _loop(str(tmp_path / "ref"), async_ckpt=async_ckpt), device="cpu")["losses"]
    d = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="injected failure"):
        loop_mod.run(CFG, _loop(d, fail_at_step=5, async_ckpt=async_ckpt), device="cpu")
    assert ckpt.latest_step(d) == 3  # the emergency path finished the pending write
    out = loop_mod.run(CFG, _loop(d, async_ckpt=async_ckpt), device="cpu")
    assert out["start_step"] == 3
    np.testing.assert_array_equal(np.asarray(out["losses"]), np.asarray(ref[3:]))
    assert ckpt.latest_step(d) == 6


def test_async_checkpoint_resume(tmp_path):
    d = str(tmp_path / "async")
    loop_mod.run(CFG, _loop(d, async_ckpt=True, steps=6), device="cpu")
    assert ckpt.latest_step(d) == 6
    again = loop_mod.run(CFG, _loop(d, async_ckpt=True, steps=6), device="cpu")
    assert again == {"losses": [], "start_step": 6, "stragglers": 0}


def test_grad_compression_error_feedback_converges():
    """Compressed gradients with error feedback train as the uncompressed
    ones do.  The reference test's criterion (the last three losses' mean
    below the first three's, 20 steps of fresh batches) reads noise on this
    port's stream: its tokens are uniform, so no model gets below
    log(vocab) on them, and at seed 0 neither run's mean falls (5.5649
    against 5.5629 compressed, 5.5637 against 5.5628 not).  So the loop's
    compressed run is held to its uncompressed twin step by step, and a
    repeated batch, which can be learned, must be learned under
    compression."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    runs = [np.asarray(loop_mod.run(
        CFG, loop_mod.LoopConfig(steps=20, batch=2, seq=16, grad_compression=comp, log_every=100),
        device="cpu")["losses"]) for comp in (True, False)]
    assert np.all(np.isfinite(runs[0]))
    assert np.max(np.abs(runs[0] - runs[1])) < 0.02
    losses = {}
    for comp in (True, False):
        state = step_mod.init_train_state(0, CFG, grad_compression=comp, device="cpu")
        batch = make_batch(CFG, 2, 16, seed=1, device="cpu")
        out = []
        for _ in range(10):
            state, m = step_mod.train_step(state, batch, CFG, adamw.AdamWConfig(lr=1e-3))
            out.append(float(m["loss"]))
        losses[comp] = np.asarray(out)
    assert losses[True][-3:].mean() < losses[True][:3].mean() - 0.1
    np.testing.assert_allclose(losses[True], losses[False], atol=0.05)


def test_stragglers_are_counted(capsys):
    slow = loop_mod.run(CFG, loop_mod.LoopConfig(steps=3, batch=2, seq=8, step_deadline_s=0.0,
                                                 log_every=100), device="cpu")
    assert slow["stragglers"] == 3
    assert capsys.readouterr().out.count("[straggler]") == 3
    fast = loop_mod.run(CFG, loop_mod.LoopConfig(steps=3, batch=2, seq=8, step_deadline_s=1e6,
                                                 log_every=100), device="cpu")
    assert fast["stragglers"] == 0
    np.testing.assert_array_equal(slow["losses"], fast["losses"])


def test_metrics_callback_and_microbatches():
    seen = []
    out = loop_mod.run(CFG, loop_mod.LoopConfig(steps=2, batch=4, seq=8, microbatches=2,
                                                log_every=100), device="cpu",
                       on_metrics=lambda it, m: seen.append((it, sorted(m))))
    assert seen == [(0, ["aux", "ce", "grad_norm", "loss"]), (1, ["aux", "ce", "grad_norm", "loss"])]
    assert len(out["losses"]) == 2


def test_launcher_trains_crashes_and_resumes_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    args = ["--preset", "tiny", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        launch_train.main(args + ["--fail-at-step", "3"])
    assert ckpt.latest_step(d) == 2
    out = launch_train.main(args)
    assert out["start_step"] == 2 and len(out["losses"]) == 2
    assert ckpt.latest_step(d) == 4
    text = capsys.readouterr().out
    assert "arch=qwen2.5-3b preset=tiny" in text and "device=cpu" in text
    assert "done: start_step=2" in text
