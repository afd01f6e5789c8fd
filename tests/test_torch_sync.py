"""The port's sync layer (``automerge_tpu_torch/sync/``: the Bloom filter,
the protocol, the resilient session and the fault harness, and
``AutoDoc.generate_sync_message`` / ``receive_sync_message``) against the
JAX package's, on the CPU.

Both packages run the same seeded scripts: the same edits under the same
actor ids (their change bytes are equal, so every hash is), the same
channel seeds. The bytes each side puts on the wire must be equal message
for message and frame for frame, and so must the driver's counts and the
final saves and heads. A port peer and a JAX-package peer, exchanging only
bytes, must reproduce the JAX pair's wire exactly. A session's resident
``DeviceDoc`` feed (``device_doc=``, ``receive_many(device_feed=)``) must
leave the port's document equal to the JAX package's fed document and to
a fresh merge of the history; a failure of the feed propagates.
"""

import random
import threading

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.sync as RS
import automerge_tpu.types as RT
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.sync as PS
import automerge_tpu_torch.types as PT
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.sync import session as RSS
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.core.document import Document as PDocument
from automerge_tpu_torch.ops import batched as B
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change as pparse
from automerge_tpu_torch.sync import session as PSS

from .test_torch_document import norm

SIDES = {"ref": (RA, RT, RS), "port": (PA, PT, PS)}
# the reference session's counts; the port's stats carry these and its
# device-feed counts
REF_STATS = ("sent", "received", "retries", "resets", "resyncs", "dups",
             "malformed", "rejected")
MAX_TICKS = 3000


class Peer:
    """One package's side of a sync: its documents, states and messages."""

    def __init__(self, side):
        self.side = side
        self.A, self.T, self.S = SIDES[side]
        self.kw = {"device": "cpu"} if side == "port" else {}

    def doc(self, i):
        return self.A.AutoDoc(self.T.ActorId(bytes([i]) * 16), **self.kw)

    def state(self, data=None):
        return self.S.SyncState() if data is None else self.S.SyncState.decode(data)


def shuttle(a, pa, b, pb, wire, sa=None, sb=None, tamper=None, rounds=100):
    """Run the protocol between ``a`` (of ``pa``'s package) and ``b`` to
    quiescence, each message crossing as bytes (appended to ``wire``)."""
    sa = sa or pa.state()
    sb = sb or pb.state()
    for _ in range(rounds):
        ma = a.generate_sync_message(sa)
        if ma is not None:
            if tamper:
                tamper(ma)
            wire.append(("a", ma.encode()))
            b.receive_sync_message(sb, pb.S.Message.decode(wire[-1][1]))
        mb = b.generate_sync_message(sb)
        if mb is not None:
            if tamper:
                tamper(mb)
            wire.append(("b", mb.encode()))
            a.receive_sync_message(sa, pa.S.Message.decode(wire[-1][1]))
        if ma is None and mb is None:
            return sa, sb
    raise AssertionError("no convergence")


def saturate(msg):
    """Every Bloom filter claims to hold everything: a forced false
    positive, so only the need list fetches what is missing."""
    for h in msg.have:
        h.bloom.bits = bytearray(b"\xff" * max(len(h.bloom.bits), 2))
        h.bloom.num_entries = max(h.bloom.num_entries, 1)


# -- scenarios: each runs on two peers' packages and returns its documents --

def sc_one_sided(pa, pb, wire):
    a = pa.doc(1)
    t = a.put_object("_root", "t", pa.T.ObjType.TEXT)
    a.splice_text(t, 0, 0, "hello sync")
    a.commit()
    b = pb.doc(2)
    shuttle(a, pa, b, pb, wire)
    assert b.text(t) == "hello sync"
    return [a, b]


def sc_bidirectional(pa, pb, wire):
    a, b = pa.doc(1), pb.doc(2)
    a.put("_root", "x", 1)
    a.commit()
    shuttle(a, pa, b, pb, wire)
    a.put("_root", "a", "from-a")
    a.commit()
    b.put("_root", "b", "from-b")
    b.commit()
    shuttle(a, pa, b, pb, wire)
    assert a.hydrate() == b.hydrate() == {"x": 1, "a": "from-a", "b": "from-b"}
    return [a, b]


def sc_multi_round(pa, pb, wire):
    a, b = pa.doc(1), pb.doc(2)
    t = a.put_object("_root", "t", pa.T.ObjType.TEXT)
    a.splice_text(t, 0, 0, "v0")
    a.commit()
    sa, sb = shuttle(a, pa, b, pb, wire)
    for i in range(3):
        a.splice_text(t, a.length(t), 0, f" a{i}")
        a.commit()
        b.splice_text(t, 0, 0, f"b{i} ")
        b.commit()
        sa, sb = shuttle(a, pa, b, pb, wire, sa, sb)
        assert a.text(t) == b.text(t)
        assert sorted(sa.shared_heads) == sorted(a.get_heads())
    wire.append(("state", sa.encode()))
    wire.append(("state", sb.encode()))
    return [a, b]


def sc_counters(pa, pb, wire):
    a, b = pa.doc(1), pb.doc(2)
    a.put("_root", "c", pa.T.ScalarValue("counter", 100))
    a.commit()
    shuttle(a, pa, b, pb, wire)
    a.increment("_root", "c", 5)
    a.commit()
    b.increment("_root", "c", 7)
    b.commit()
    shuttle(a, pa, b, pb, wire)
    assert a.get("_root", "c")[0] == b.get("_root", "c")[0] == ("counter", 112)
    return [a, b]


def sc_state_reuse(pa, pb, wire):
    a, b = pa.doc(1), pb.doc(2)
    for i in range(20):
        a.put("_root", f"k{i}", i)
        a.commit()
    sa, sb = shuttle(a, pa, b, pb, wire)
    a.put("_root", "new", True)
    a.commit()
    msg = a.generate_sync_message(sa)
    assert len(msg.changes) == 1  # only the fresh change travels
    wire.append(("a", msg.encode()))
    return [a, b]


def sc_peer_data_loss(pa, pb, wire):
    a, b = pa.doc(1), pb.doc(2)
    a.put("_root", "k", 1)
    a.commit()
    sa, sb = shuttle(a, pa, b, pb, wire)
    # b is wiped and restarts with the persisted shared_heads state
    b2 = pb.doc(3)
    wire.append(("state", sb.encode()))
    shuttle(a, pa, b2, pb, wire, pa.state(sa.encode()), pb.state(sb.encode()))
    assert b2.hydrate() == a.hydrate()
    return [a, b, b2]


def sc_bloom_false_positive(pa, pb, wire):
    a, b = pa.doc(1), pb.doc(2)
    for i in range(6):
        a.put("_root", f"a{i}", i)
        a.commit()
        b.put("_root", f"b{i}", i)
        b.commit()
    shuttle(a, pa, b, pb, wire, tamper=saturate)
    assert a.hydrate() == b.hydrate() and len(a.hydrate()) == 12
    return [a, b]


def sc_topology(pa, pb, wire):
    """Four documents of the two packages alternating, synced pairwise at
    random (seeded), then swept."""
    rng = random.Random(42)
    peers = [pa, pb, pa, pb]
    docs = [p.doc(10 + i) for i, p in enumerate(peers)]

    def pair(x, y):
        shuttle(docs[x], peers[x], docs[y], peers[y], wire)

    docs[0].put("_root", "seed", 1)
    docs[0].commit()
    for j in range(1, 4):
        pair(0, j)
    lst = docs[0].put_object("_root", "l", pa.T.ObjType.LIST)
    docs[0].commit()
    for j in range(1, 4):
        pair(0, j)
    for step in range(10):
        d = rng.choice(range(4))
        ln = docs[d].length(lst)
        docs[d].insert(lst, rng.randrange(ln + 1), step)
        docs[d].commit()
        pair(*rng.sample(range(4), 2))
    for i in range(4):
        for j in range(i + 1, 4):
            pair(i, j)
    assert all(d.hydrate() == docs[0].hydrate() for d in docs)
    return docs


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_one_sided, sc_bidirectional, sc_multi_round, sc_counters, sc_state_reuse,
    sc_peer_data_loss, sc_bloom_false_positive, sc_topology)}


def run_scenario(name, side_a, side_b):
    wire = []
    docs = SCENARIOS[name](Peer(side_a), Peer(side_b), wire)
    return wire, [(d.get_heads(), d.save(), d.hydrate()) for d in docs]


@pytest.mark.parametrize("name", SCENARIOS)
def test_lockstep_equals_the_reference(name):
    """A port pair and a JAX pair: every message's bytes, then every
    document's heads, save and contents."""
    ref_wire, ref_docs = run_scenario(name, "ref", "ref")
    wire, docs = run_scenario(name, "port", "port")
    assert len(wire) == len(ref_wire) and ref_wire
    for k, (got, want) in enumerate(zip(wire, ref_wire)):
        assert got == want, f"{name}: message {k} differs"
    assert docs == ref_docs


@pytest.mark.parametrize("order", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("name", SCENARIOS)
def test_a_port_peer_and_a_reference_peer_converge(name, order):
    """A port AutoDoc and a JAX-package AutoDoc exchanging bytes only
    reproduce the JAX pair's wire and end with its heads and saves (the
    Bloom false positive forces the need path)."""
    ref_wire, ref_docs = run_scenario(name, "ref", "ref")
    wire, docs = run_scenario(name, *order)
    assert wire == ref_wire
    assert docs == ref_docs


# -- the Bloom filter --------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 100, 1000])
def test_bloom_filters_equal_the_reference(n):
    rng = np.random.default_rng(n)
    hashes = [rng.bytes(32) for _ in range(n)]
    probes = [rng.bytes(32) for _ in range(4000)]
    ref, port = RS.BloomFilter.from_hashes(hashes), PS.BloomFilter.from_hashes(hashes)
    data = ref.to_bytes()
    assert port.to_bytes() == data
    got = [port.contains(h) for h in hashes + probes]
    assert got == [ref.contains(h) for h in hashes + probes]
    assert all(got[:n])
    if n == 1000:
        assert 0 < sum(got[n:]) < 120  # false positives, ~1%
    back = PS.BloomFilter.from_bytes(data)
    assert back == port and back.to_bytes() == data
    for cut in range(len(data)):
        want = _raises(RS.BloomFilter.from_bytes, data[:cut])
        assert _raises(PS.BloomFilter.from_bytes, data[:cut]) == want


def _raises(fn, *args):
    """The kind of error ``fn(*args)`` raises, or its result's bytes."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the kind is compared
        return ("raise", type(e).__name__)
    return ("ok", out.encode() if hasattr(out, "encode") else out.to_bytes())


# -- messages and states -----------------------------------------------------

def _message_bytes():
    a = RA.AutoDoc(RT.ActorId(bytes([1]) * 16))
    t = a.put_object("_root", "t", RT.ObjType.TEXT)
    a.splice_text(t, 0, 0, "héllo")
    a.put("_root", "k", 1)
    a.commit()
    b = RA.AutoDoc(RT.ActorId(bytes([2]) * 16))
    b.put("_root", "b", 2)
    b.commit()
    sa, sb = RS.SyncState(), RS.SyncState()
    out = []
    for _ in range(6):
        for x, y, sx, sy in ((a, b, sa, sb), (b, a, sb, sa)):
            m = x.generate_sync_message(sx)
            if m is not None:
                out.append(m.encode())
                y.receive_sync_message(sy, RS.Message.decode(out[-1]))
    return out, (sa.encode(), sb.encode())


def test_messages_and_states_round_trip_to_the_reference_bytes():
    msgs, states = _message_bytes()
    assert len(msgs) >= 3 and any(RS.Message.decode(m).changes for m in msgs)
    for data in msgs:
        m = PS.Message.decode(data)
        assert m.encode() == data
        r = RS.Message.decode(data)
        assert [c.hash for c in m.changes] == [c.hash for c in r.changes]
        assert (m.heads, m.need) == (r.heads, r.need)
        assert [(h.last_sync, h.bloom.to_bytes()) for h in m.have] == \
            [(h.last_sync, h.bloom.to_bytes()) for h in r.have]
        # built afresh from its parts, the port writes the same bytes
        built = PS.Message(list(m.heads), list(m.need),
                           [PS.Have(h.last_sync, PS.BloomFilter.from_bytes(
                               h.bloom.to_bytes())) for h in m.have],
                           [pparse(c.raw_bytes)[0] for c in r.changes])
        assert built.encode() == data
    for data in states:
        s = PS.SyncState.decode(data)
        assert s.encode() == data and s.shared_heads == RS.SyncState.decode(data).shared_heads
    assert PS.SyncState().encode() == RS.SyncState().encode()


def test_malformed_messages_raise_syncerror_where_the_reference_does():
    """The reference's malformed inputs raise the port's SyncError; every
    prefix of every message and seeded byte flips of each are refused, or
    decoded to the same bytes, exactly where the reference does."""
    from automerge_tpu.utils.leb128 import uleb_bytes

    a = RA.AutoDoc(RT.ActorId(bytes([1]) * 16))
    a.put("_root", "k", 1)
    a.commit()
    msg = a.generate_sync_message(RS.SyncState()).encode()
    for bad in (b"", b"\x41\x00", msg[:5], msg[:-3]):
        with pytest.raises(PS.SyncError):
            PS.Message.decode(bad)
    assert PS.Message.decode(msg).encode() == msg
    hostile = bytearray([0x42, 0]) + bytearray([0]) + bytearray([1]) + bytes([0])
    bloom = uleb_bytes(1) + uleb_bytes(10) + uleb_bytes(10**15) + b"\x00\x02"
    hostile += uleb_bytes(len(bloom)) + bloom + bytes([0])
    with pytest.raises(PS.SyncError):
        PS.Message.decode(bytes(hostile))
    from automerge_tpu_torch import errors

    assert errors.SyncError is PS.SyncError and "SyncError" in errors.__all__

    msgs, states = _message_bytes()
    rng = random.Random(20)
    cases = []
    for data in msgs + [msg, bytes(hostile)]:
        cases += [data[:k] for k in range(len(data))]
        for _ in range(60):
            flip = bytearray(data)
            flip[rng.randrange(len(flip))] ^= 1 << rng.randrange(8)
            cases.append(bytes(flip))
    refused = 0
    for data in cases:
        want = _raises(RS.Message.decode, data)
        assert _raises(PS.Message.decode, data) == want, data.hex()
        refused += want[0] == "raise"
    assert 0 < refused < len(cases)
    for data in states:
        for k in range(len(data)):
            assert _raises(PS.SyncState.decode, data[:k]) == \
                _raises(RS.SyncState.decode, data[:k])


def test_a_native_library_failure_is_not_a_malformed_message(monkeypatch):
    """The change parser's native column check failing to build is not
    malformed input: it propagates from ``Message.decode`` and from a
    session's ``receive``, where the reference would count a malformed
    frame."""
    from automerge_tpu_torch import native
    from automerge_tpu_torch.storage import change as C

    msgs, _ = _message_bytes()
    data = next(m for m in msgs if RS.Message.decode(m).changes)

    def missing(*a, **k):
        raise native.NativeUnavailable("g++ not found")

    monkeypatch.setattr(C.native, "change_check", missing)
    with pytest.raises(native.NativeUnavailable):
        PS.Message.decode(data)
    sess = PS.SyncSession(Peer("port").doc(5), epoch=1)
    with pytest.raises(native.NativeUnavailable):
        sess.receive(PSS.encode_frame(2, data, 0, 1), 0)
    assert sess.stats["malformed"] == 0


# -- sessions over faulty channels --------------------------------------------

def recording(ch, log):
    """Record what ``ch`` is given and what it delivers."""
    send, drain = ch.send, ch.drain

    def rec_send(data, now=0):
        log.append(("send", now, bytes(data)))
        send(data, now)

    def rec_drain(now):
        out = drain(now)
        log.append(("drain", now, tuple(out)))
        return out

    ch.send, ch.drain = rec_send, rec_drain
    return ch


def make_peers(rng, peer, n_a=(1, 6), n_b=(1, 6), n_base=(0, 4)):
    """The reference suite's peers: optional shared history plus
    divergent tails, drawn from ``rng``."""
    a, b = peer.doc(1), peer.doc(2)
    for i in range(rng.randrange(*n_base)):
        a.put("_root", f"base{i}", i)
        a.commit()
    b.merge(a)
    for i in range(rng.randrange(*n_a)):
        a.put("_root", f"a{i}", i)
        a.commit()
    for i in range(rng.randrange(*n_b)):
        b.put("_root", f"b{i}", i)
        b.commit()
    return a, b


def observe(stats, a, b, log):
    return {
        "converged": stats.converged, "ticks": stats.ticks,
        "a": {k: stats.a[k] for k in REF_STATS}, "b": {k: stats.b[k] for k in REF_STATS},
        "ab": stats.channel_ab.as_dict(), "ba": stats.channel_ba.as_dict(),
        "log": log, "heads": (a.get_heads(), b.get_heads()),
        "saves": (a.save(), b.save()),
    }


def run_schedule(side, seed, truncate_max=0.0, bitflip_max=0.0):
    """The reference's ``run_schedule`` on ``side``'s package, recorded."""
    peer = Peer(side)
    S = peer.S
    rng = random.Random(seed * 7919)
    rates = dict(
        drop=rng.uniform(0.1, 0.4), dup=rng.uniform(0.1, 0.4),
        reorder=rng.uniform(0.1, 0.4),
        truncate=rng.uniform(0.0, truncate_max) if truncate_max else 0.0,
        bitflip=rng.uniform(0.0, bitflip_max) if bitflip_max else 0.0,
    )
    a, b = make_peers(rng, peer)
    log = []
    drv = S.SyncDriver(a, b, recording(S.FaultyChannel(seed=seed, **rates), log),
                       recording(S.FaultyChannel(seed=seed + 10_000, **rates), log))
    stats = drv.run(max_ticks=MAX_TICKS)
    assert stats.converged and a.get_heads() == b.get_heads(), (side, seed)
    if side == "port":
        for s in (stats.a, stats.b):
            assert s["coalesced_batches"] == 0 and not any(s["device_feeds"].values())
    return observe(stats, a, b, log)


def assert_same_run(got, want, what):
    for k in want:
        assert got[k] == want[k], f"{what}: {k} differs"


@pytest.mark.parametrize("batch", range(8))
def test_lossy_schedules_equal_the_reference(batch):
    """The reference's 200 seeds of ``test_converges_under_lossy_schedules``:
    the frames each channel is given and delivers, the driver's counts and
    the final documents equal the reference's."""
    for seed in range(batch * 25, (batch + 1) * 25):
        assert_same_run(run_schedule("port", seed), run_schedule("ref", seed),
                        f"seed {seed}")


@pytest.mark.parametrize("batch", range(8))
def test_corrupting_schedules_equal_the_reference(batch):
    """The same 200 seeds with truncation and bit flips on top
    (``test_converges_under_corrupting_schedules``)."""
    for seed in range(batch * 25, (batch + 1) * 25):
        assert_same_run(run_schedule("port", seed, 0.15, 0.15),
                        run_schedule("ref", seed, 0.15, 0.15), f"seed {seed}")


def larger(side, seed):
    peer = Peer(side)
    a, b = peer.doc(1), peer.doc(2)
    t = a.put_object("_root", "t", peer.T.ObjType.TEXT)
    a.commit()
    b.merge(a)
    for i in range(60):
        a.put("_root", f"a{i}", i)
        a.splice_text(t, 0, 0, f"<a{i}>")
        a.commit()
        b.put("_root", f"b{i}", i)
        b.splice_text(t, b.length(t), 0, f"<b{i}>")
        b.commit()
    log = []
    S = peer.S
    drv = S.SyncDriver(
        a, b,
        recording(S.FaultyChannel(seed=seed, drop=0.3, dup=0.2, reorder=0.3,
                                  truncate=0.05, bitflip=0.05), log),
        recording(S.FaultyChannel(seed=seed + 99, drop=0.3, dup=0.2, reorder=0.3,
                                  truncate=0.05, bitflip=0.05), log))
    stats = drv.run(max_ticks=MAX_TICKS)
    assert stats.converged and a.text(t) == b.text(t)
    return observe(stats, a, b, log)


@pytest.mark.parametrize("seed", range(4))
def test_larger_histories_equal_the_reference(seed):
    assert_same_run(larger("port", seed), larger("ref", seed), f"seed {seed}")


# -- session machinery, each case on both packages -----------------------------

def case_reliable_driver(peer):
    a, b = make_peers(random.Random(0), peer)
    log = []
    S = peer.S
    stats = S.SyncDriver(a, b, recording(S.Channel(), log), recording(S.Channel(), log)).run()
    assert stats.converged and stats.a["retries"] == stats.b["retries"] == 0
    return observe(stats, a, b, log)


def case_garbage(peer):
    a, _ = make_peers(random.Random(1), peer)
    sess = peer.S.SyncSession(a, epoch=1)
    got = [sess.receive(x) for x in (b"", b"\x00\x01\x02", b"\x45truncated",
                                     b"\x42\x01", b"\x45" + bytes(8))]
    return {"got": got, "stats": {k: sess.stats[k] for k in REF_STATS}}


def case_duplicates(peer):
    a, b = make_peers(random.Random(2), peer)
    sa = peer.S.SyncSession(a, epoch=1)
    sb = peer.S.SyncSession(b, epoch=2)
    frame = sa.poll(1)
    out = [frame, sb.receive(frame, 1), sb.receive(frame, 2), sb.poll(3)]
    assert out[1] is True and out[2] is False and out[3] is not None
    return {"out": out, "stats": {k: sb.stats[k] for k in REF_STATS}}


def case_backoff(peer):
    a, _ = make_peers(random.Random(3), peer)
    cfg = peer.S.SessionConfig(timeout=2.0, backoff_factor=2.0, max_timeout=16.0,
                               jitter=0.25, seed=9)
    sess = peer.S.SyncSession(a, config=cfg, epoch=1)
    frames = [sess.poll(now) for now in range(0, 200)]
    return {"frames": frames, "timeout": sess._cur_timeout,
            "stats": {k: sess.stats[k] for k in REF_STATS}}


def case_epoch_handshake(peer):
    """A peer that loses its session mid-sync recovers through the epoch
    handshake from its persisted shared_heads (``encode`` / ``restore``)."""
    a, b = make_peers(random.Random(4), peer)
    S = peer.S
    sa, sb = S.SyncSession(a, epoch=1), S.SyncSession(b, epoch=2)
    frames = []
    for now in range(1, 4):
        fa = sa.poll(now)
        if fa is not None:
            frames.append(fa)
            sb.receive(fa, now)
        fb = sb.poll(now)
        if fb is not None:
            frames.append(fb)
            sa.receive(fb, now)
    saved = sb.encode()
    sb2 = S.SyncSession.restore(b, saved, epoch=3)
    log = []
    stats = S.SyncDriver(a, b, recording(S.Channel(), log), recording(S.Channel(), log),
                         session_a=sa, session_b=sb2).run()
    assert stats.converged and sa.stats["resets"] >= 1 and sa.peer_epoch == 3
    return {**observe(stats, a, b, log), "frames": frames, "saved": saved}


def case_forced_resync(peer):
    a, b = make_peers(random.Random(5), peer)
    S = peer.S
    sa, sb = S.SyncSession(a, epoch=1), S.SyncSession(b, epoch=2)
    sa.state.sent_hashes.update(c.hash for c in sa._doc.get_changes([]))
    log = []
    stats = S.SyncDriver(a, b, recording(S.Channel(), log), recording(S.Channel(), log),
                         session_a=sa, session_b=sb).run()
    assert stats.converged and stats.a["resyncs"] + stats.b["resyncs"] >= 1
    return observe(stats, a, b, log)


def case_bare_protocol(peer):
    a, b = make_peers(random.Random(6), peer)
    msg = peer.S.generate_sync_message(b.doc, peer.state())
    sess = peer.S.SyncSession(a, epoch=1)
    assert sess.receive(msg.encode(), 0) is True
    return {"their_heads": sess.state.their_heads, "frame": sess.poll(1),
            "stats": {k: sess.stats[k] for k in REF_STATS}}


def case_rejected(peer):
    """A well-framed message whose change the document refuses (a
    reincarnated actor's divergent seq 1) is absorbed and counted."""
    a, ghost = peer.doc(1), peer.doc(1)
    a.put("_root", "x", 1)
    a.commit()
    ghost.put("_root", "x", 999)
    ghost.commit()
    gs = peer.S.SyncSession(ghost, epoch=5)
    gs.state.their_have = []
    gs.state.their_need = [c.hash for c in ghost.doc.get_changes([])]
    frame = gs.poll(0)
    sess = peer.S.SyncSession(a, epoch=1)
    assert sess.receive(frame, 0) is False
    return {"frame": frame, "stats": {k: sess.stats[k] for k in REF_STATS}}


def case_frames(peer):
    enc, dec = (RSS if peer.side == "ref" else PSS).encode_frame, \
        (RSS if peer.side == "ref" else PSS).decode_frame
    out = []
    for epoch, inner, flags, seq in ((7, b"payload", 1, 3), (1, b"", 0, 0),
                                     (300, b"\x42" * 40, 1, 2 ** 40)):
        frame = enc(epoch, inner, flags, seq)
        out.append((frame, dec(frame)))
        for i in range(len(frame)):
            bad = bytearray(frame)
            bad[i] ^= 0x10
            out.append(_raises_frame(dec, bytes(bad)))
            out.append(_raises_frame(dec, frame[:i]))
    import zlib

    payload = bytes([0x00, 0x80])
    crafted = bytes([0x45]) + (zlib.crc32(payload) & 0xFFFFFFFF).to_bytes(4, "big") + payload
    out.append(_raises_frame(dec, crafted))
    return out


def _raises_frame(dec, data):
    try:
        return ("ok", dec(data))
    except (RS.SyncError, PS.SyncError) as e:
        return ("SyncError", str(e))


CASES = {f.__name__[5:]: f for f in (
    case_reliable_driver, case_garbage, case_duplicates, case_backoff,
    case_epoch_handshake, case_forced_resync, case_bare_protocol, case_rejected,
    case_frames)}


@pytest.mark.parametrize("name", CASES)
def test_session_machinery_equals_the_reference(name):
    assert CASES[name](Peer("port")) == CASES[name](Peer("ref"))


def test_session_encode_and_restore_bytes():
    """``encode`` is the state's shared heads, byte for byte the
    reference's; ``restore`` reads either package's bytes."""
    out = {}
    for side in ("ref", "port"):
        peer = Peer(side)
        a, b = make_peers(random.Random(12), peer)
        stats = peer.S.SyncDriver(a, b).run()
        assert stats.converged
        sess = peer.S.SyncSession(a, epoch=4)
        sess.state.shared_heads = a.get_heads()
        out[side] = sess.encode()
    assert out["port"] == out["ref"]
    for data in out.values():
        r = PS.SyncSession.restore(Peer("port").doc(1), data, epoch=9)
        assert r.epoch == 9 and r.state.shared_heads == RS.SyncState.decode(data).shared_heads


def test_persist_hook_is_called_on_progress_and_retries_after_a_failure():
    peer = Peer("port")
    a, b = make_peers(random.Random(13), peer)
    calls, fail = [], [True]

    def persist(data):
        if fail[0]:
            fail[0] = False
            raise OSError("disk full")
        calls.append(data)

    sb = PS.SyncSession(b, epoch=2, persist=persist)
    stats = PS.SyncDriver(a, b, session_b=sb).run()
    assert stats.converged
    assert sb.stats["persist_errors"] == 1
    assert calls and calls[-1] == sb.encode()
    assert PS.SyncState.decode(calls[-1]).shared_heads == sorted(b.get_heads())


def test_faulty_channels_equal_the_reference():
    """A seeded channel's schedule: the bytes it delivers and its counts."""
    def run(S, seed):
        ch = S.FaultyChannel(seed=seed, drop=0.3, dup=0.3, reorder=0.3,
                             truncate=0.2, bitflip=0.2)
        out = []
        for i in range(200):
            ch.send(bytes([i % 256]) * (1 + i % 40), now=i)
            out.append(ch.drain(i))
        sch = S.FaultyChannel(seed=seed, schedule=["drop", "dup", "ok", "reorder",
                                                    "truncate", "bitflip"] * 3)
        for i in range(18):
            sch.send(bytes([i]) * 9, i)
        out.append(sch.drain(100))
        return ch.stats.as_dict(), sch.stats.as_dict(), out

    for seed in (0, 7, 42):
        assert run(PS, seed) == run(RS, seed)
    with pytest.raises(ValueError):
        PS.FaultyChannel(schedule=["explode"]).send(b"x", 0)


# -- the resident device feed ---------------------------------------------------

def fed_pair(side, deliver, seed=0, rounds=3):
    """b's session feeds a resident DeviceDoc of b's history while a
    edits in ``rounds`` rounds (text, list, counter, map); ``deliver``
    is "receive" (one frame at a time) or "many" (a tick's frames through
    ``receive_many``). Returns (a, b, b's resident document, session)."""
    peer = Peer(side)
    rng = random.Random(seed)
    base = peer.doc(1)
    t = base.put_object("_root", "t", peer.T.ObjType.TEXT)
    base.splice_text(t, 0, 0, "the quick brown fox")
    lst = base.put_object("_root", "l", peer.T.ObjType.LIST)
    for i in range(5):
        base.insert(lst, i, i * 10)
    base.put("_root", "c", peer.T.ScalarValue("counter", 5))
    base.commit()
    saved = base.save()
    load = peer.A.AutoDoc.load
    a, b = load(saved, **peer.kw), load(saved, **peer.kw)
    a.set_actor(peer.T.ActorId(bytes([3]) * 16))
    hist = [x.stored for x in b.doc.history]
    if side == "port":
        dev = DeviceDoc.resolve(OpLog.from_changes(hist), device="cpu")
    else:
        dev = JDeviceDoc.resolve(JOpLog.from_changes(hist))
    S = peer.S
    sa, sb = S.SyncSession(a, epoch=1), S.SyncSession(b, epoch=2, device_doc=dev)
    now = 0
    for r in range(rounds):
        for _ in range(1 + r):
            ln = a.length(t)
            a.splice_text(t, rng.randrange(ln + 1), rng.randrange(0, 2) if ln else 0,
                          f"<{r}>")
            a.insert(lst, rng.randrange(a.length(lst) + 1), r)
            a.increment("_root", "c", rng.randrange(1, 5))
            a.put("_root", f"k{rng.randrange(3)}", r)
            a.commit()
        pending = []
        for _ in range(40):
            now += 1
            fa = sa.poll(now)
            if fa is not None:
                pending.append(fa)
            if deliver == "receive":
                for f in pending:
                    sb.receive(f, now)
                pending.clear()
            elif len(pending) >= 2 or (fa is None and pending):
                sb.receive_many(list(pending), now)
                pending.clear()
            fb = sb.poll(now)
            if fb is not None:
                sa.receive(fb, now)
            if sa.converged() and sb.converged() and not pending:
                break
        assert sa.converged() and sb.converged()
    return a, b, dev, sb


def assert_same_device_doc(doc, jdoc):
    n = doc.log.n
    assert (n, doc.log.n_objs) == (jdoc.log.n, jdoc.log.n_objs)
    np.testing.assert_array_equal(doc.log.id_key, np.asarray(jdoc.log.id_key)[:n])
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(doc.res[k])[:cut],
                                      np.asarray(jdoc.res[k])[:cut], err_msg=k)
    assert norm(doc.hydrate()) == norm(jdoc.hydrate())
    assert sorted(doc.current_heads()) == sorted(jdoc.current_heads())


@pytest.mark.parametrize("deliver", ["receive", "many"])
@pytest.mark.parametrize("seed", [0, 1])
def test_session_feeds_the_device_doc_as_the_reference_does(deliver, seed):
    """The port's version of ``test_sync_session_feeds_device_doc`` (and,
    delivered through ``receive_many``, of the serving layer's coalesced
    feed): the port's resident document equals the JAX package's, fed
    through its own session, and a fresh merge of b's history."""
    a, b, dev, sb = fed_pair("port", deliver, seed)
    ja, jb, jdev, _ = fed_pair("ref", deliver, seed)
    assert a.save() == ja.save() and b.get_heads() == jb.get_heads()
    assert_same_device_doc(dev, jdev)
    fresh = DeviceDoc.resolve(OpLog.from_changes([x.stored for x in b.doc.history]),
                              device="cpu")
    assert_same_device_doc(dev, fresh)
    feeds = sb.stats["device_feeds"]
    if deliver == "receive":
        assert feeds["apply_changes"] > 0 and feeds["apply_batches"] == 0
        assert sb.stats["coalesced_batches"] == 0
    else:
        assert feeds["apply_batches"] > 0 and sb.stats["coalesced_batches"] > 0
    assert feeds["device_feed"] == 0


def test_receive_many_batches_the_device_feed():
    """The port's version of ``test_session_receive_many_batches_device_feed``:
    every change reaches the device through one ``apply_batches`` call a
    run of frames, the calls the reference makes."""
    out = {}
    for side in ("ref", "port"):
        peer = Peer(side)
        a, b = peer.doc(1), peer.doc(2)
        for i in range(3):
            a.put("_root", f"k{i}", i)
            a.commit()

        class RecordingDev:
            def __init__(self):
                self.batch_calls, self.change_calls = [], []

            def apply_batches(self, batches):
                self.batch_calls.append([len(x) for x in batches])

            def apply_changes(self, changes):
                self.change_calls.append(len(changes))

        dev = RecordingDev()
        sa = peer.S.SyncSession(a, epoch=1)
        sb = peer.S.SyncSession(b, epoch=2, device_doc=dev)
        pending = []
        for now in range(40):
            fa = sa.poll(now)
            if fa is not None:
                pending.append(fa)
            if len(pending) >= 2 or (fa is None and pending):
                sb.receive_many(list(pending), now)
                pending.clear()
            fb = sb.poll(now)
            if fb is not None:
                sa.receive(fb, now)
            if sa.converged() and sb.converged():
                break
        assert a.get_heads() == b.get_heads()
        assert dev.batch_calls and not dev.change_calls
        assert sum(n for call in dev.batch_calls for n in call) == len(b.doc.history)
        out[side] = (dev.batch_calls, {k: sb.stats[k] for k in REF_STATS})
        if side == "port":
            assert sb.stats["device_feeds"]["apply_batches"] == len(dev.batch_calls)
            assert sb.stats["coalesced_batches"] == sum(len(c) for c in dev.batch_calls)
    assert out["port"] == out["ref"]


def serve_peers(n_docs, cycles, ops, ballast, device="cpu"):
    """Server documents (an AutoDoc and a resident DeviceDoc each) and
    their clients, all holding the serve workload's base, with sessions
    settled over reliable channels."""
    base, deltas, texts = W.serve_workload(n_docs, cycles, ops, ballast)
    peer = Peer("port")
    servers, devs, clients, ss, cs = [], [], [], [], []
    for i in range(n_docs):
        s, c = peer.doc(100 + i), peer.doc(200 + i)
        for d in (s, c):
            d.apply_changes([pparse(base)[0]])
        servers.append(s)
        clients.append(c)
        devs.append(DeviceDoc.merge([base], device=device))
        ss.append(PS.SyncSession(s, epoch=1, device_doc=devs[-1]))
        cs.append(PS.SyncSession(c, epoch=2))
    return base, deltas, texts, servers, devs, clients, ss, cs


def converse(csess, ssess, now, feed=None):
    """Rounds of client poll, server ``receive_many`` (into ``feed``, when
    given, as the serving layer drains), server poll and client receive,
    until both sides have converged. Returns the rounds taken."""
    for k in range(20):
        t = now + k
        frame = csess.poll(t)
        ssess.receive_many([frame] if frame is not None else [], t, device_feed=feed)
        reply = ssess.poll(t)
        if reply is not None:
            csess.receive(reply, t)
        if csess.converged() and ssess.converged():
            return k + 1
    raise AssertionError("no convergence")


def test_receive_many_into_the_cross_doc_batcher_equals_each_documents_own_apply():
    """Every cycle, one thread a document drains its server session with
    ``receive_many(frames, now, device_feed=lambda b: batcher.apply(dev, b))``
    into a ``CrossDocBatcher`` on the CPU; each resident document then
    equals a twin fed the same batches by its own ``apply_batches``, and a
    fresh merge of its server's history."""
    n, cycles = 8, 3
    base, deltas, texts, servers, devs, clients, ss, cs = serve_peers(n, cycles, 6, 40)
    twins = [DeviceDoc.merge([base], device="cpu") for _ in range(n)]
    for i in range(n):
        converse(cs[i], ss[i], 0)
    batcher = B.CrossDocBatcher(mode="1", window_ms=2000.0, max_docs=4, device="cpu")
    locks = [threading.Lock() for _ in range(n)]
    B.reset_stats()
    for c in range(cycles):
        now = 100 * (c + 1)
        for i in range(n):
            clients[i].apply_changes([pparse(deltas[i][c])[0]])
        fed = [[] for _ in range(n)]
        errs = []

        def feed(i, batches):
            fed[i] += [list(b) for b in batches]
            return batcher.apply(devs[i], batches)

        def worker(i):
            try:
                with locks[i]:
                    converse(cs[i], ss[i], now, lambda b, i=i: feed(i, b))
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        for i in range(n):
            assert [len(b) for b in fed[i]] == [1]
            twins[i].apply_batches(fed[i])
            assert servers[i].get_heads() == clients[i].get_heads()
            assert_same_device_doc(devs[i], twins[i])
            fresh = DeviceDoc.merge([servers[i]], device="cpu")
            assert_same_device_doc(devs[i], fresh)
    assert B.stats()["launches"] >= cycles * n // 4
    assert [d.text(W.SERVE_LIVE) for d in devs] == texts
    for s in ss:
        assert s.stats["device_feeds"] == {"apply_changes": 0, "apply_batches": 0,
                                           "device_feed": cycles}


# -- failure injection ------------------------------------------------------------

class FeedFault(RuntimeError):
    pass


def _broken(*a, **k):
    raise FeedFault("injected launch failure")


@pytest.mark.parametrize("how", ["receive", "receive_many", "device_feed"])
def test_a_failed_device_feed_propagates_and_the_host_keeps_the_changes(how, monkeypatch):
    """The reference counts a failed feed and carries on; the port raises
    it from ``receive`` / ``receive_many``. The host document already holds
    the message's changes, the frame is counted, and a later message loses
    nothing."""
    peer = Peer("port")
    a, b = peer.doc(1), peer.doc(2)
    a.put("_root", "x", 1)
    a.commit()
    dev = DeviceDoc.resolve(OpLog.from_changes([]), device="cpu")
    sa = PS.SyncSession(a, epoch=1)
    sb = PS.SyncSession(b, epoch=2, device_doc=dev)
    # settle the heads, then a's change travels in one frame
    sb.receive(sa.poll(1), 1)
    sa.receive(sb.poll(2), 2)
    frame = sa.poll(3)
    assert frame is not None and PS.Message.decode(PSS.decode_frame(frame)[3]).changes
    received = sb.stats["received"]
    if how == "receive":
        monkeypatch.setattr(DeviceDoc, "apply_changes", _broken)
        call = lambda: sb.receive(frame, 3)  # noqa: E731
    elif how == "receive_many":
        monkeypatch.setattr(DeviceDoc, "apply_batches", _broken)
        call = lambda: sb.receive_many([frame, b"\x45junk"], 3)  # noqa: E731
    else:
        call = lambda: sb.receive_many([frame], 3, device_feed=_broken)  # noqa: E731
    with pytest.raises(FeedFault):
        call()
    assert b.get_heads() == a.get_heads() and b.hydrate() == {"x": 1}
    assert sb.stats["received"] == received + 1 and sb.stats["rejected"] == 0
    monkeypatch.undo()
    # a later message: nothing lost on the host
    a.put("_root", "y", 2)
    a.commit()
    stats = PS.SyncDriver(a, b, session_a=sa, session_b=sb).run()
    assert stats.converged and b.hydrate() == {"x": 1, "y": 2}
    assert b.get_heads() == a.get_heads()


@pytest.mark.parametrize("how", ["kernel", "durable"])
def test_a_failure_of_the_document_is_not_a_rejected_frame(how, monkeypatch):
    """Only the document's own refusal (an AutomergeError) is absorbed as a
    rejected frame; a failure of the kernels or the native library under
    ``apply_changes``, or of a durable write path (a change listener
    raising OSError), propagates."""
    peer = Peer("port")
    a, b = peer.doc(1), peer.doc(2)
    for i in range(3):
        a.put("_root", f"k{i}", i)
        a.commit()
    gs = PS.SyncSession(a, epoch=5)
    gs.state.their_have = []
    gs.state.their_need = [c.hash for c in a.doc.get_changes([])]
    frame = gs.poll(0)
    sess = PS.SyncSession(b, epoch=1)
    if how == "kernel":
        monkeypatch.setattr(PDocument, "apply_changes", _broken)
        with pytest.raises(FeedFault):
            sess.receive(frame, 0)
        assert b.get_heads() == []
    else:
        def journal(change):
            raise OSError("disk full")

        b.doc.change_listeners.append(journal)
        with pytest.raises(OSError):
            sess.receive(frame, 0)
        b.doc.change_listeners.clear()
    assert sess.stats["rejected"] == 0
    monkeypatch.undo()
    stats = PS.SyncDriver(a, b, session_b=sess).run()
    assert stats.converged and b.hydrate() == a.hydrate()


def test_bulk_catch_up_over_sync_merges_once_for_the_read_and_the_rebuild(monkeypatch):
    """A catch-up over a session large enough for the bulk path: the first
    read is stale (one merge), the first edit rebuilds from that merge
    (none), and its text equals the JAX package's."""
    from automerge_tpu_torch.ops import merge as M

    monkeypatch.setattr(PDocument, "BULK_MIN_OPS", 50)
    calls = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for side in ("ref", "port"):
        peer = Peer(side)
        a, b = peer.doc(1), peer.doc(2)
        t = a.put_object("_root", "t", peer.T.ObjType.TEXT)
        for i in range(40):
            a.splice_text(t, i % 7, 0, f"<{i}>")
            a.commit()
        # the typing's first commits are session exports of most of a small
        # document: each leaves a's op store stale and its next splice
        # rebuilds it (a merge each); count b's merges only
        calls.clear()
        stats = peer.S.SyncDriver(
            a, b, peer.S.FaultyChannel(seed=3, drop=0.2, dup=0.2, reorder=0.2),
            peer.S.FaultyChannel(seed=4, drop=0.2, dup=0.2, reorder=0.2)).run()
        assert stats.converged
        if side == "port":
            assert b.doc._ops_stale and calls == []
        read = b.text(t)
        if side == "port":
            assert calls == [1] and b.doc._ops_stale
        b.splice_text(t, 3, 0, "edit")
        b.commit(timestamp=1)
        if side == "port":
            assert calls == [1] and not b.doc._ops_stale
        out[side] = (read, b.text(t), b.save())
    assert out["port"] == out["ref"]
