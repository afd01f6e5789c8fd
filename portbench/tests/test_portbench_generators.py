"""The frozen generators against the port's own (``workload.py`` with
``build_change``): the same bytes at seed 0, other bytes at another seed,
and the counts the generators promise."""

import pytest

from automerge_tpu_torch import workload as W
from portbench.documents import text_trace


def test_text_seed0_bytes_equal_the_ports(small):
    cfg = dict(small["edit_trace_1024"], trace_inserts=182315, trace_deletes=77463,
               typing_cycle=46, trace_seed=0)
    got = text_trace.generate(cfg, 0)
    trace = W.typing_trace(cfg["trace_edits"], 0)
    base = W.build_base(trace, cfg["base_edits"])
    reps = W.synth_fanin(base, trace, cfg["replicas"], cfg["per_replica"], cfg["base_edits"])
    assert got["chunks"] == [c.raw_bytes for c in base.changes + reps]
    assert got["n_ops"] == [len(c.ops) for c in base.changes + reps]
    assert got["obj"] == base.text_exid


@pytest.mark.parametrize("mod,name", [(text_trace, "edit_trace_1024")])
def test_another_seed_gives_other_bytes_of_the_same_size(small, mod, name):
    cfg = dict(small[name], trace_inserts=182315, trace_deletes=77463, typing_cycle=46,
               trace_seed=0)
    a, b = mod.generate(cfg, 0), mod.generate(cfg, 2**31 + 11)
    assert a["chunks"][1:] != b["chunks"][1:]
    assert len(a["chunks"]) == len(b["chunks"]) == cfg["replicas"] + 1
    assert a["n_ops"] == b["n_ops"]  # every seed the same op counts
    assert a["work"] == b["work"]


def test_text_counts_hold(small):
    cfg = dict(small["edit_trace_1024"], trace_inserts=182315, trace_deletes=77463,
               typing_cycle=46, trace_seed=0)
    got = text_trace.generate(cfg, 5)
    ref = got["ref"]
    n = len(got["chunks"])
    assert got["work"]["ops"] == sum(got["n_ops"])
    assert got["n_ops"][0] == 1 + cfg["base_edits"]  # one op an edit, and the make
    deleted = {(int(c), int(a)) for c, a in zip(ref["del_ctr"], ref["del_actor"])}
    assert len(text_trace.want(got, n)) == len(ref["ins_ctr"]) - len(deleted)
