"""What decides ``correct``: the whole run, on the CPU at small sizes,
with the program put right, with the control (the reference, its
guarantee broken) in its place, and with the timed path broken
underneath in each way a cell can break: a step that returns its state
unchanged, half of each batch left out, an answer altered where it is
produced, and an iteration that skips its kernels. One card a cell, so
no exchange between cards can be left out."""

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _bench():
    return harness.load_benchmark()


def _run(cell, small, port=None, seed=21):
    return harness.run_cell(_bench(), cell, seed, 0.3, False, "cpu", port=port,
                            cfg_override=small[cell.split(".")[0]])


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell, small):
    r = _run(cell, small)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, small):
    r = control.run_state(cell, 21, 0.3, True, small[cell.split(".")[0]], _bench())
    assert not r["correct"], r["checks"]
    ref = control.run_state(cell, 21, 0.3, False, small[cell.split(".")[0]], _bench())
    assert ref["correct"], ref["checks"]


class Unchanged(harness.Port):
    """A step that returns its state unchanged."""

    def merge(self, chunks, device, phases=None):
        return super().merge(chunks[:1], device, phases)

    def apply_batches(self, doc, batches, phases=None):
        return 0


class Half(harness.Port):
    """Half of the changes left out: of a merge's replicas, of a served
    call's batches."""

    def merge(self, chunks, device, phases=None):
        return super().merge(chunks[:1 + (len(chunks) - 1) // 2], device, phases)

    def apply_batches(self, doc, batches, phases=None):
        return super().apply_batches(doc, batches[:len(batches) // 2], phases)


class _AlteredDoc:
    """A document whose reads come back with one answer altered."""

    def __init__(self, doc):
        self._doc = doc

    def __getattr__(self, name):
        return getattr(self._doc, name)

    def apply_batches(self, batches, phases=None):
        return self._doc.apply_batches(batches, phases)

    def text(self, obj):
        t = self._doc.text(obj)
        return ("b" if t[:1] == "a" else "a") + t[1:]


class Altered(harness.Port):
    def merge(self, chunks, device, phases=None):
        return _AlteredDoc(super().merge(chunks, device, phases))


class Skipping(harness.Port):
    """The second timed iteration launches less than the others."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def _tick(self):
        self.calls += 1

    def merge(self, chunks, device, phases=None):
        self._tick()
        return super().merge(chunks, device, phases)

    def apply_batches(self, doc, batches, phases=None):
        self._tick()
        return super().apply_batches(doc, batches, phases)

    def launches(self) -> dict:
        # one launch a call, but the fourth call of the run launches none
        return {"k": self.calls - (self.calls >= 4)}


@pytest.mark.parametrize("fault", [Unchanged, Half, Altered, Skipping])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, small):
    r = _run(cell, small, port=fault())
    assert not r["correct"], (r["checks"], r["failed"])
