"""The sharded merge's collectives and its condensed expansion (K11) on
the CPU: ``mesh_reduce`` (``jax.lax.psum`` / ``pmax``,
``automerge_tpu/parallel/sharding.py:138-139, 154-162, 341-342``) over a
list of tables against its stacked form and numpy's int32 sum and max;
``psum`` / ``pmax`` folding the tables where they lie (only other
devices' copied); ``cond_expand`` (:320-334) over the whole row range
against the shards' slices; and the whole sharded merge over meshes of
one device repeated and of distinct devices, both arms, against the JAX
package's ``sharded_merge_columns``, exactly, with its folds and
expansions counted per device.
"""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.kernels import collectives as CK
from automerge_tpu_torch.kernels import sharded as SH
from automerge_tpu_torch.parallel import Mesh, sharded_merge_columns
from automerge_tpu_torch.parallel import collectives as C
from automerge_tpu_torch.parallel import sharding as PS

from .test_torch_sharded import _assert_outputs_equal, _jax_sharded, _workload

I32 = np.iinfo(np.int32)


def _tables(n, L, seed):
    """n int32 [L] tables of any int32, each holding the extremes and
    values whose sum wraps: 2^31 - 1 beside 1, -2^31 beside -1."""
    rng = np.random.default_rng(seed)
    a = rng.integers(I32.min, I32.max + 1, (n, L), dtype=np.int64).astype(np.int32)
    special = [I32.max, 1, I32.min, -1, 0]
    for s in range(n):
        k = min(L, len(special))
        a[s, :k] = np.roll(special, s)[:k]
    return a


def _numpy_fold(a, op):
    # numpy's int32 sum wraps, as XLA's int32 psum does
    return a.max(0) if op == "max" else a.sum(0, dtype=np.int32)


@pytest.mark.parametrize("op", CK.OPS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, CK.CAP, 9, 16, 33])
def test_mesh_reduce_of_parts_equals_its_stack_and_numpy(n, op):
    a = _tables(n, 37, n)
    parts = [torch.from_numpy(row.copy()) for row in a]
    got = CK.mesh_reduce(parts, op)
    assert got.dtype == torch.int32 and got.shape == (37,)
    np.testing.assert_array_equal(got.numpy(), _numpy_fold(a, op))
    assert torch.equal(got, CK.mesh_reduce(torch.from_numpy(a), op))
    assert torch.equal(got, CK.mesh_reduce_plain(parts, op))
    assert torch.equal(got, CK.mesh_reduce_plain(torch.from_numpy(a), op))


def test_mesh_reduce_wraps_at_the_int32_edges():
    parts = [torch.tensor(v, dtype=torch.int32) for v in
             ([I32.max, I32.min, I32.max, 5], [1, -1, I32.max, -5])]
    assert CK.mesh_reduce(parts, "sum").tolist() == [I32.min, I32.max, -2, 0]
    assert CK.mesh_reduce(parts, "max").tolist() == [I32.max, -1, I32.max, 5]


def test_mesh_reduce_keeps_the_shape_of_a_table():
    a = _tables(3, 24, 7).reshape(3, 2, 12)
    parts = [torch.from_numpy(t.copy()) for t in a]
    got = CK.mesh_reduce(parts, "sum")
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), _numpy_fold(a, "sum"))


@pytest.mark.parametrize("fn", [CK.mesh_reduce, CK.mesh_reduce_plain])
def test_mesh_reduce_raises_past_the_cap_and_on_bad_parts(fn):
    """Past ``CAP`` tables both fold (the fold in passes, the plain
    version at once), as a list and as a stack; they raise only on bad
    parts."""
    a = _tables(CK.CAP + 1, 4, 3)
    parts = [torch.from_numpy(t.copy()) for t in a]
    np.testing.assert_array_equal(fn(parts, "sum").numpy(), _numpy_fold(a, "sum"))
    np.testing.assert_array_equal(fn(torch.from_numpy(a), "max").numpy(),
                                  _numpy_fold(a, "max"))
    with pytest.raises(ValueError):
        fn([], "sum")
    with pytest.raises(ValueError):
        fn([torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)],
           "sum")
    with pytest.raises(TypeError):
        fn([torch.zeros(4, dtype=torch.int64)], "sum")
    with pytest.raises(ValueError):
        fn([torch.zeros(4, dtype=torch.int32)], "min")


@pytest.mark.parametrize("n", [9, 16, 17, 33, 64, 65])
def test_mesh_reduce_past_the_cap_folds_in_passes(monkeypatch, n):
    """Past ``CAP`` tables the fold runs in passes: groups of ``CAP``
    into partials (a group of one carried over as it is), then the
    partials; ``passes(n)`` folds of at most ``CAP`` tables, each table
    read once, the first pass's tables where they lie."""
    a = _tables(n, 29, n)
    parts = [torch.from_numpy(t.copy()) for t in a]
    calls = []
    launch = CK._launch

    def spy(tables, op):
        calls.append([t.data_ptr() for t in tables])
        return launch(tables, op)

    monkeypatch.setattr(CK, "_launch", spy)
    for op in CK.OPS:
        calls.clear()
        got = CK.mesh_reduce(parts, op)
        np.testing.assert_array_equal(got.numpy(), _numpy_fold(a, op))
        assert len(calls) == CK.passes(n)
        assert all(1 < len(c) <= CK.CAP for c in calls)
        first = [p for c in calls for p in c if p in {t.data_ptr() for t in parts}]
        assert sorted(first) == sorted(t.data_ptr() for t in parts)
    assert CK.passes(1) == CK.passes(CK.CAP) == 1


@pytest.mark.parametrize("fn", [C.psum, C.pmax])
def test_psum_and_pmax_refuse_bad_tables_at_any_mesh_size(fn):
    """The collective checks the tables once, for the fold: one
    contiguous int32 table of one shape a shard, at any mesh size (a
    mesh past ``CAP`` shards folds)."""
    table = torch.zeros(4, dtype=torch.int32)
    n = 2 * CK.CAP + 1
    got = fn(Mesh(["cpu"] * n), [table + i for i in range(n)])
    want = n * (n - 1) // 2 if fn is C.psum else n - 1
    assert got[torch.device("cpu")].tolist() == [want] * 4
    for mesh in (Mesh(["cpu"] * 2), Mesh(["cpu"] * n)):
        for bad in ([table], [table, torch.zeros(5, dtype=torch.int32)],
                    [table, torch.zeros(4, dtype=torch.int64)],
                    [table, torch.zeros(8, dtype=torch.int32)[::2]]):
            bad = bad + [table] * (mesh.size - 2) if len(bad) == 2 else bad
            with pytest.raises(ValueError):
                fn(mesh, bad)


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu:0", "cpu:0", "cpu:1", "cpu:1"],
                                     ["cpu:0", "cpu:1", "cpu:0"]],
                         ids=["one-device", "two-runs", "interleaved"])
def test_psum_and_pmax_fold_the_tables_where_they_lie(monkeypatch, devices):
    """One fold a distinct device; its tables in shard order, those of
    the shards on that device the parts themselves, the others' copied
    into a staging buffer there: ``copied`` counts only those, ``bytes``
    the reference's volume (every device receives every shard's table)."""
    mesh = Mesh(devices)
    L = 3 * 41
    a = _tables(mesh.size, L, 11)
    parts = [torch.from_numpy(t.copy()).reshape(3, 41) for t in a]
    calls = []
    fold = C.fold

    def spy(tables, op):
        calls.append([t.data_ptr() for t in tables])
        return fold(tables, op)

    monkeypatch.setattr(C, "fold", spy)
    C.reset_stats()
    for kind, fn in (("psum", C.psum), ("pmax", C.pmax)):
        calls.clear()
        got = fn(mesh, parts)
        assert list(got) == list(mesh.distinct)
        for t in got.values():
            assert t.shape == (3, 41)
            want = _numpy_fold(a, "sum" if kind == "psum" else "max")
            np.testing.assert_array_equal(t.reshape(-1).numpy(), want)
        assert len(calls) == len(mesh.distinct)
        for d, ptrs in zip(mesh.distinct, calls):
            for i, dev in enumerate(mesh.devices):
                assert (ptrs[i] == parts[i].data_ptr()) == (dev == d), (d, i)
        remote = sum(mesh.size - mesh.devices.count(d) for d in mesh.distinct)
        assert C.stats[kind] == {"calls": 1,
                                 "bytes": len(mesh.distinct) * mesh.size * L * 4,
                                 "copied": remote * L * 4}
    if len(mesh.distinct) == 1:
        assert C.stats["psum"]["copied"] == C.stats["pmax"]["copied"] == 0


def _expand_inputs(P, R2, n_objs2, seed):
    """cond_expand's inputs: chain ids, offsets and object ids partly out
    of range (clamped) or negative, insert and pad rows mixed, chain
    distances of any int32 (their differences wrap)."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, k):
        return torch.from_numpy(rng.integers(lo, hi, k).astype(np.int32))

    action = ints(0, 16, P)
    action[rng.random(P) < 0.2] = 15
    return (ints(-1, R2 + 3, P), ints(-5, 50, P), ints(0, n_objs2 + 2, P),
            torch.from_numpy(rng.random(P) < 0.7), action,
            ints(-1, R2, n_objs2),
            torch.from_numpy(rng.integers(I32.min, I32.max + 1, R2, dtype=np.int64)
                             .astype(np.int32)))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_cond_expand_over_all_rows_equals_the_shards_slices(shards):
    P, R2, n_objs2 = 8 * 37, 64, 9
    args = _expand_inputs(P, R2, n_objs2, shards)
    Pl = P // shards
    whole = SH.cond_expand(*args, 0, P)
    sliced = torch.cat([SH.cond_expand(*args, i * Pl, Pl) for i in range(shards)])
    assert torch.equal(whole, sliced)
    assert torch.equal(whole, SH.cond_expand_plain(*args, 0, P))
    assert (whole == -1).any() and (whole != -1).any()


def test_cond_expand_fills_an_offset_out_view_in_place():
    P = 101
    args = _expand_inputs(P, 32, 5, 9)
    buf = torch.full((P + 10,), -7, dtype=torch.int32)
    for r0, count in ((0, P), (3, 50), (57, 44), (P, 0)):
        out = buf[5:5 + count]
        got = SH.cond_expand(*args, r0, count, out=out)
        assert got is out
        assert torch.equal(buf[5:5 + count], SH.cond_expand_plain(*args, r0, count))
    assert buf[:5].tolist() == [-7] * 5
    with pytest.raises(ValueError):
        SH.cond_expand(*args, 0, 10, out=torch.empty(9, dtype=torch.int32))


MESHES = {
    "one-device": ["cpu"] * 4,
    "two-devices": ["cpu:0", "cpu:1"],
    "two-runs": ["cpu:0", "cpu:0", "cpu:1", "cpu:1"],
}


@pytest.mark.parametrize("linearize", PS.LINEARIZE)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["forks", "sort_fallback", "typing_fanin",
                                  "no_sequence"])
def test_sharded_merge_folds_and_expands_once_per_device(monkeypatch, name,
                                                         mesh_name, linearize):
    """The whole sharded merge equals the JAX package's on all 13
    outputs; psum and pmax fold once per distinct device (4 collectives
    past the scatter gate, the psum of the counts alone below it), copying
    nothing on one device and only the other devices' tables otherwise;
    the condensed arm expands once per run of shards on a device."""
    cols, n_objs, n_props = _workload(name)
    mesh = Mesh(MESHES[mesh_name])
    folds, expands = [], []
    fold, expand = C.fold, PS.cond_expand

    def fold_spy(tables, op):
        folds.append(op)
        return fold(tables, op)

    def expand_spy(*args, **kw):
        expands.append(args[-2:])
        return expand(*args, **kw)

    monkeypatch.setattr(C, "fold", fold_spy)
    monkeypatch.setattr(PS, "cond_expand", expand_spy)
    C.reset_stats()
    got = sharded_merge_columns(cols, mesh, n_objs=n_objs, n_props=n_props,
                                linearize=linearize)
    _assert_outputs_equal(got, _jax_sharded(name, mesh.size), f"{name} {mesh_name}")
    P = len(cols["action"])
    Pl = P // mesh.size
    n_objs2 = n_objs + 2 if n_objs is not None else P + 2
    scatter = PS.sharded_gate(P, n_objs2, n_props if n_props is not None else P)
    k = len(mesh.distinct)
    assert len(folds) == (4 if scatter else 1) * k
    assert (C.stats["pmax"]["calls"], C.stats["psum"]["calls"]) == (
        (1, 3) if scatter else (0, 1))
    remote = sum(mesh.size - mesh.devices.count(d) for d in mesh.distinct)
    for kind in ("psum", "pmax"):
        s = C.stats[kind]
        assert s["copied"] * k * mesh.size == s["bytes"] * remote
    if linearize == "rows":
        assert expands == []
    elif k == 1:
        assert expands == [(0, P)]
    else:
        assert expands == [(first * Pl, count * Pl) for _, first, count in mesh.runs]


# -- past the cap: 16 shards against the JAX package's 16-device merge ----------

SIXTEEN = {
    "one-device": ["cpu"] * 16,
    "two-devices": ["cpu:0"] * 8 + ["cpu:1"] * 8,
}
SIXTEEN_WORKLOADS = ("forks", "typing_fanin")
# the JAX side runs in a process of its own: tier-1's conftest fixes 8
# virtual CPU devices, and the device count is read once, at backend start
_JAX16 = """
import sys
import numpy as np
import automerge_tpu.parallel.sharding as JS
from automerge_tpu.parallel import default_mesh
from tests.test_torch_sharded import _workload
out = {}
for name in sys.argv[2:]:
    cols, n_objs, n_props = _workload(name)
    res = JS.sharded_merge_columns(cols, default_mesh(16), n_objs=n_objs,
                                   n_props=n_props)
    for k, v in cols.items():
        out[f"{name}/cols/{k}"] = np.asarray(v)
    out[f"{name}/meta"] = np.array([-1 if n_objs is None else n_objs,
                                    -1 if n_props is None else n_props])
    for k, v in res.items():
        out[f"{name}/res/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax16(tmp_path_factory):
    """The workloads' padded columns and the JAX package's
    ``sharded_merge_columns`` over 16 virtual CPU devices, from one
    subprocess with a timeout of its own."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    path = tmp_path_factory.mktemp("jax16") / "jax16.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16",
               PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", _JAX16, str(path), *SIXTEEN_WORKLOADS],
                   cwd=root, env=env, check=True, timeout=300)
    data = np.load(path)
    out = {}
    for name in SIXTEEN_WORKLOADS:
        cols = {k.split("/")[2]: data[k] for k in data.files
                if k.startswith(f"{name}/cols/")}
        res = {k.split("/")[2]: data[k] for k in data.files
               if k.startswith(f"{name}/res/")}
        n_objs, n_props = (None if v < 0 else int(v) for v in data[f"{name}/meta"])
        out[name] = cols, n_objs, n_props, res
    return out


@pytest.mark.parametrize("transport", PS.TRANSPORTS)
@pytest.mark.parametrize("linearize", PS.LINEARIZE)
@pytest.mark.parametrize("mesh_name", sorted(SIXTEEN))
@pytest.mark.parametrize("name", SIXTEEN_WORKLOADS)
def test_sixteen_shards_equal_the_jax_sixteen_device_merge(
        monkeypatch, jax16, name, mesh_name, linearize, transport):
    """A mesh of 16 shards, past the one-launch fold's ``CAP``: all 13
    outputs equal the JAX package's merge over 16 devices, exactly; each
    collective folds its 16 tables once a distinct device, in passes."""
    cols, n_objs, n_props, want = jax16[name]
    mesh = Mesh(SIXTEEN[mesh_name])
    sizes = []
    fold = C.fold

    def fold_spy(tables, op):
        sizes.append(len(tables))
        return fold(tables, op)

    monkeypatch.setattr(C, "fold", fold_spy)
    got = sharded_merge_columns(cols, mesh, n_objs=n_objs, n_props=n_props,
                                linearize=linearize, transport=transport)
    _assert_outputs_equal(got, want, f"{name} {mesh_name} {linearize} {transport}")
    assert sizes and set(sizes) == {16}
    assert len(sizes) % len(mesh.distinct) == 0
