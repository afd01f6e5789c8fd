"""The plain reference against the port's own CPU merge
(``DeviceDoc.merge(..., device="cpu")``) on small fan-ins of the
configuration, on fan-ins of part of the replicas, and after a few
served batches (``apply_batches``)."""

import numpy as np
import pytest

from automerge_tpu_torch.ops.device_doc import DeviceDoc
from portbench.documents import text_trace

KINDS = [(text_trace, "edit_trace_1024")]
EXTRA = dict(trace_inserts=182315, trace_deletes=77463, typing_cycle=46, trace_seed=0)


def _check(mod, doc, inputs, n_changes, seed=0):
    expect = mod.want(inputs, n_changes)
    extra = mod.after_window(doc, inputs, expect, np.random.default_rng(seed))
    got = mod.compare(mod.read(doc, inputs), expect, extra)
    assert got and all(v == 0 for v in got.values()), got
    return expect


@pytest.mark.parametrize("mod,name", KINDS)
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_reference_equals_the_ports_cpu_merge(small, mod, name, seed):
    inputs = mod.generate(dict(small[name], **EXTRA), seed)
    for n in (1, 9, len(inputs["chunks"])):
        doc = DeviceDoc.merge(inputs["chunks"][:n], device="cpu")
        _check(mod, doc, inputs, n, seed)


@pytest.mark.parametrize("mod,name", KINDS)
def test_reference_equals_the_port_after_served_batches(small, mod, name):
    inputs = mod.generate(dict(small[name], **EXTRA), 9)
    chunks = inputs["chunks"]
    doc = DeviceDoc.merge(chunks[:1], device="cpu")
    doc.apply_batches([chunks[1 + i:2 + i] for i in range(12)])  # one change a batch
    _check(mod, doc, inputs, 13)
    doc.apply_batches([chunks[13:17]])
    _check(mod, doc, inputs, 17)


@pytest.mark.parametrize("mod,name", KINDS)
def test_the_control_differs_from_the_reference(small, mod, name):
    inputs = mod.generate(dict(small[name], **EXTRA), 4)
    n = len(inputs["chunks"])
    doc = mod.StateDoc(mod.want(inputs, n, control=True))
    expect = mod.want(inputs, n)
    extra = mod.after_window(doc, inputs, expect, np.random.default_rng(0))
    got = mod.compare(mod.read(doc, inputs), expect, extra)
    assert any(v > 0 for v in got.values()), got
