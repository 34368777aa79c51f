"""Each cell's check, driven through a whole run on the CPU with the timed
path broken underneath: every fault the cell can have must come out as
``correct: false``, and the unbroken run as ``correct: true``.

The faults: a step that returns its state unchanged, half of the batch
left out, and an answer altered where it is produced.  Every cell runs on
one card, so there is no exchange between cards to leave out.
"""
import pytest

from perfbench.tests import small


def _sec6_state_unchanged(mp):
    from repro_torch.runtime import TwoPhasePipeline

    orig = TwoPhasePipeline.append

    def append(self, elems, mask=None, **kw):
        if self.stats.appends == 3:  # the fourth wave leaves the array as it was
            self.stats.registry.counter("runtime.appends").inc()
            return None
        return orig(self, elems, mask, **kw)

    mp.setattr(TwoPhasePipeline, "append", append)


def _sec6_half_batch(mp):
    from repro_torch.runtime import TwoPhasePipeline

    orig = TwoPhasePipeline.append

    def append(self, elems, mask=None, **kw):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False  # the second half of the blocks left out
        return orig(self, elems, mask, **kw)

    mp.setattr(TwoPhasePipeline, "append", append)


def _sec6_answer_altered(mp):
    from repro_torch.runtime import TwoPhasePipeline

    orig = TwoPhasePipeline.map_frozen

    def map_frozen(self, fn):
        def bent(x):
            y = fn(x)
            y[7] += 1
            return y

        return orig(self, bent)

    mp.setattr(TwoPhasePipeline, "map_frozen", map_frozen)


SEC6_FAULTS = {"state_unchanged": _sec6_state_unchanged, "half_batch": _sec6_half_batch,
               "answer_altered": _sec6_answer_altered}


def test_sec6_cell_correct_when_unbroken():
    line, _ = small.run("gg-sec6-512")
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(SEC6_FAULTS))
def test_sec6_cell_catches(fault, monkeypatch):
    SEC6_FAULTS[fault](monkeypatch)
    line, _ = small.run("gg-sec6-512")
    assert not line["correct"], line["checks"]


def test_sec6_control_is_not_correct():
    """The control, the reference in bf16 in the program's place, fails the
    cell's committed limits where the program passes them."""
    line, rec = small.run("gg-sec6-512", control=True)
    assert not line["correct"], line["checks"]
    assert line["checks"]["mismatches"]["value"] > 0 and rec.control["program_mismatches"] == 0
