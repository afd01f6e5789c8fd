"""The reference's integration corpus (``tests/test_ported.py``, the
upstream ``rust/automerge/tests/test.rs`` scenarios) on the port.

Each scenario runs twice from the same source: once as written, on the
JAX package, and once with the names it imports bound to the port's
(``AutoDoc``, ``Document``, ``DeviceDoc``, ``AutomergeError``,
``expanded``, the ``testing`` DSL, the types, and the change parser and
patches its scenarios import), its documents and their device merges on
the CPU. Actor ids come from ``os.urandom``;
both runs of a scenario draw them from one seeded stream, so they make
the same documents. The scenario's own assertions run on the port, on
its ``AutoDoc`` and on its ``DeviceDoc`` (``check``), and every
document the scenario realizes (``check``, ``assert_doc``,
``assert_obj``, ``realize``) must equal the reference's realization at
the same point. All 63 scenarios run on the port.
"""

import importlib.util
import inspect
import os
import random
import sys
import zlib
from pathlib import Path

import pytest

import automerge_tpu.testing as REF_TESTING
import automerge_tpu_torch.testing as PTS
from automerge_tpu_torch import expanded as PE
from automerge_tpu_torch.core.document import Document as _PDocument
from automerge_tpu_torch.errors import AutomergeError as PAutomergeError
from automerge_tpu_torch.ops.device_doc import DeviceDoc as _PDeviceDoc
from automerge_tpu_torch.types import ActorId, ObjType, ScalarValue

from tests.test_torch_durable import AutoDoc as CpuAutoDoc

SRC = Path(__file__).with_name("test_ported.py")


class CpuDocument(_PDocument):
    def __init__(self, actor=None, text_encoding=None, device="cpu"):
        super().__init__(actor, text_encoding, device=device)

    @classmethod
    def load(cls, data, *a, **kw):
        kw.setdefault("device", "cpu")
        return super().load(data, *a, **kw)


class CpuDeviceDoc(_PDeviceDoc):
    @classmethod
    def merge(cls, changes, device="cpu", **kw):
        return super().merge(changes, device=device, **kw)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SRC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("ported_corpus_reference")
PORT = _load("ported_corpus_port")
PORT.__dict__.update(
    AutoDoc=CpuAutoDoc,
    Document=CpuDocument,
    DeviceDoc=CpuDeviceDoc,
    AutomergeError=PAutomergeError,
    collapse_change=PE.collapse_change,
    expand_change=PE.expand_change,
    ActorId=ActorId,
    ObjType=ObjType,
    ScalarValue=ScalarValue,
    assert_doc=PTS.assert_doc,
    assert_obj=PTS.assert_obj,
    list_=PTS.list_,
    map_=PTS.map_,
    new_doc=lambda seed=None: PTS.new_doc(seed, device="cpu"),
    realize=PTS.realize,
    sorted_actors=PTS.sorted_actors,
    text_=PTS.text_,
)

SCENARIOS = sorted(
    n for n, f in vars(REF).items()
    if n.startswith("test_") and inspect.isfunction(f)
)


def _record(mod, seen):
    """Wrap the module's realizing helpers to log what they realize."""
    realize = mod.realize
    realize_obj = (PTS if mod is PORT else REF_TESTING).realize_obj

    def rec_realize(doc, heads=None):
        out = realize(doc, heads=heads)
        seen.append(("realize", out))
        return out

    def rec_assert_doc(doc, expected, heads=None):
        seen.append(("doc", realize(doc, heads=heads)))
        return assert_doc(doc, expected, heads=heads)

    def rec_assert_obj(doc, obj, expected, heads=None):
        seen.append(("obj", obj, realize_obj(doc, obj, heads=heads)))
        return assert_obj(doc, obj, expected, heads=heads)

    assert_doc, assert_obj = mod.assert_doc, mod.assert_obj
    return {"realize": rec_realize, "assert_doc": rec_assert_doc,
            "assert_obj": rec_assert_obj}


def _port_modules():
    """What the scenarios' own imports resolve to on the port: its change
    parser and patches. The port writes no compressed change chunk, so
    the reference's ``compress_chunk`` makes that input (the port reads
    it)."""
    import types

    import automerge_tpu.storage.chunk as rchunk
    import automerge_tpu_torch.patches.patch as ppatch
    import automerge_tpu_torch.storage.change as pchange

    chunk = types.ModuleType("chunk_writer")
    chunk.compress_chunk = rchunk.compress_chunk
    return {"automerge_tpu.storage.chunk": chunk,
            "automerge_tpu.storage.change": pchange,
            "automerge_tpu.patches.patch": ppatch}


def _run(mod, name, monkeypatch, tmp_path):
    seen = []
    rng = random.Random(zlib.crc32(name.encode()))
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", lambda n: rng.randbytes(n))
        if mod is PORT:
            for k, v in _port_modules().items():
                m.setitem(sys.modules, k, v)
        for k, v in _record(mod, seen).items():
            m.setattr(mod, k, v)
        fn = getattr(mod, name)
        kwargs = {}
        if "tmp_path" in inspect.signature(fn).parameters:
            kwargs["tmp_path"] = tmp_path / mod.__name__
            kwargs["tmp_path"].mkdir()
        fn(**kwargs)
    return seen


def test_corpus_is_the_reference_s():
    assert len(SCENARIOS) == 63


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_on_the_port_equals_the_reference(name, monkeypatch, tmp_path):
    want = _run(REF, name, monkeypatch, tmp_path)
    got = _run(PORT, name, monkeypatch, tmp_path)
    assert got == want
