"""automerge_tpu_torch stands alone: it imports neither JAX nor anything
of automerge_tpu (its sharded merge, ``parallel/``, included), and its
entry points refuse to fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import automerge_tpu_torch
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.device import resolve_device
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.merge import merge_columns
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch import workload as W

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "automerge_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_NO_JAX_RUN = r"""
import importlib, pkgutil, sys
import automerge_tpu_torch
for m in pkgutil.walk_packages(automerge_tpu_torch.__path__, "automerge_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops.device_doc import DeviceDoc
trace = W.load_trace(300)
base = W.build_base(trace, 200)
changes = base.changes + W.synth_fanin(base, trace, 3, 20, 200)
doc = DeviceDoc.merge([c.raw_bytes for c in changes], device="cpu")
assert len(doc.text(base.text_exid)) == W.expected_text_length(changes)
packed = DeviceDoc.merge([c.raw_bytes for c in changes], device="cpu",
                         transport="packed")
assert packed.text(base.text_exid) == doc.text(base.text_exid)
expand = DeviceDoc.merge([c.raw_bytes for c in changes], device="cpu",
                         staging="expand")
assert expand.text(base.text_exid) == doc.text(base.text_exid)
rbase, reps, expect = W.record_store(64, 8, 20)
served = DeviceDoc.merge([rbase.raw_bytes], device="cpu")
served.apply_changes([r.raw_bytes for r in reps[:4]])
served.apply_batches(W.record_batches([r.raw_bytes for r in reps[4:]], 2))
assert W.record_counts(served) == expect
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import linearize_condensed
from automerge_tpu_torch.ops.merge import condensed_caps, merge_kernel_condensed
from automerge_tpu_torch.ops.oplog import OpLog
tbase = W.build_base(W.typing_trace(300, 1), 200)
tlog = OpLog.from_changes(tbase.changes)
cond = merge_kernel_condensed(condensed_caps(tlog))(
    columns_from_numpy(tlog.padded_columns(include_aorder=True), "cpu"))
assert int((cond["elem_index"] >= 0).sum()) == int(tlog.insert.sum())
assert linearize_condensed.linearize_condensed.launches == 0
from automerge_tpu_torch.ops.merge import merge_columns
from automerge_tpu_torch.parallel import default_mesh, sharded_merge_columns
log = OpLog.from_changes(changes)
kw = dict(n_objs=log.n_objs, n_props=len(log.props))
single = merge_columns(log.padded_columns(), device="cpu", **kw)
for arm in ("condensed", "rows"):
    out = sharded_merge_columns(log.padded_columns(),
                                default_mesh(devices=["cpu"] * 2),
                                linearize=arm, **kw)
    assert all((out[k][:len(v)] == v).all() for k, v in single.items())
mesh_runs = []
inner = DeviceDoc._mesh_resolve_inner
DeviceDoc._mesh_resolve_inner = lambda self: mesh_runs.append(1) or inner(self)
mdoc = DeviceDoc.merge([c.raw_bytes for c in changes[:-1]], device="cpu")
mdoc.enable_mesh(devices=["cpu"] * 2, min_rows=0)
mdoc.apply_changes([changes[-1].raw_bytes])
assert mesh_runs == [1] and mdoc.text(base.text_exid) == doc.text(base.text_exid)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "automerge_tpu") or m.startswith(("jax.", "automerge_tpu."))
)
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def _forbidden(name: str) -> bool:
    return name in ("jax", "automerge_tpu") or name.startswith(("jax.", "automerge_tpu."))


def test_port_imports_and_merges_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FORBIDDEN []" in r.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def _cols():
    trace = W.load_trace(100)
    base = W.build_base(trace, 80)
    return base, OpLog.from_changes(base.changes).columns()


def test_entry_points_without_device_raise_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, cols = _cols()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        merge_columns(cols)
    with pytest.raises(RuntimeError):
        columns_from_numpy(cols)
    with pytest.raises(RuntimeError):
        DeviceDoc.merge([c.raw_bytes for c in base.changes])
    with pytest.raises(RuntimeError):
        merge_columns(cols, device="cuda")
    with pytest.raises(RuntimeError):
        merge_columns(cols, transport="packed", staging="expand")
    rbase, reps, _ = W.record_store(16, 2, 20)
    with pytest.raises(RuntimeError):
        DeviceDoc.merge([rbase.raw_bytes])
    with pytest.raises(RuntimeError):
        DeviceDoc(OpLog.from_changes([rbase]), {})


def test_served_document_stays_on_its_device(monkeypatch):
    """A document resolved on the CPU applies and re-resolves there; it
    never reaches for the card."""
    rbase, reps, expect = W.record_store(64, 8, 20)
    doc = DeviceDoc.merge([rbase.raw_bytes], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert doc.apply_changes([r.raw_bytes for r in reps[:4]]) == 4
    assert doc.apply_batches(
        W.record_batches([r.raw_bytes for r in reps[4:]], 2)) == 4
    assert W.record_counts(doc) == expect


def test_cpu_is_taken_only_when_asked():
    _, cols = _cols()
    assert resolve_device("cpu") == torch.device("cpu")
    out = merge_columns(cols, device="cpu")
    assert isinstance(out["winner"], np.ndarray)
    assert set(automerge_tpu_torch.__all__) == {"DeviceDoc", "OpLog", "merge_columns"}
    assert automerge_tpu_torch.DeviceDoc is DeviceDoc
