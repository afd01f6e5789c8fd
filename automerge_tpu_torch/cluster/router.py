"""The router tier: consistent-hash placement, proxying, failover.

``ClusterRouter`` speaks the exact line-delimited JSON-RPC framing on
both sides: clients connect to it as if it were a single server, and it
fans their requests out to backend shard groups (a leader plus its
followers, cluster/node.py). Placement is by durable document name on a
consistent-hash ring (cluster/hashring.py) plus a migration override
table; handle ids are virtualized so a client never sees (or depends
on) which node owns its documents.

Ordering: requests from one client connection against one document flow
through one router thread onto one pooled node connection, and the
node's per-document shard queue serializes them — same-doc requests
keep arrival order end to end.

Failover: a heartbeat monitor polls each group leader's
``clusterStatus``; consecutive misses (or a connection death observed
by the data path) trigger failover — the group freezes, every reachable
follower reports its durable replication cursor, the **longest durable
acked prefix** wins promotion (follower states are strict prefixes of
the leader's ship order, so "longest" is well-defined), surviving
followers are rewired onto the new leader, and the group unfreezes.
Virtual handles re-resolve lazily: a durable doc re-opens by name on
the new leader, an attached sync session re-attaches by (doc, peer) —
the epoch bump makes the client's surviving session renegotiate via the
epoch/reset handshake instead of a full resync. Requests in flight on
the dead node answer ``Unavailable`` (retriable); requests arriving
during the freeze wait it out.

Live shard migration (``clusterMigrate``): snapshot while serving, then
pause the doc, ship the journal tail, flip the override, release the
source — the compaction dance, across two nodes.

Run: ``python -m automerge_tpu_torch.cluster.router --listen HOST:PORT
--group addr,addr,... [--group ...]``.

The port of ``automerge_tpu/cluster/router.py``, line for line: the
router touches no device (it proxies bytes), so it routes nodes of
either package, and each package's nodes behind it.
"""

from __future__ import annotations

import contextlib
import json
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..serve.admission import priority_class
from .hashring import HashRing
from .replication import _env_float

_CREATES = {
    # method -> result field that carries a fresh handle, and its kind
    "create": ("doc", "doc"),
    "load": ("doc", "doc"),
    "fork": ("doc", "doc"),
    "openDurable": ("doc", "doc"),
    "syncStateNew": ("sync", "sync"),
    "syncStateDecode": ("sync", "sync"),
    "syncSessionNew": ("session", "session"),
    "syncSessionRestore": ("session", "session"),
    "syncSessionAttach": ("session", "session"),
}

_FREES = {"free": "doc", "syncStateFree": "sync", "syncSessionFree": "session"}

# params fields that carry handles, by name
_HANDLE_PARAMS = ("doc", "other", "sync", "session")

_ROUTER_METHODS = frozenset({
    "metrics", "clusterMetrics", "clusterInfo", "clusterMigrate",
    "clusterJoin", "clusterAdvise", "shutdown"})


class _VHandle:
    """One virtualized client handle."""

    __slots__ = ("kind", "group", "real", "gen", "name", "doc_vid", "peer")

    def __init__(self, kind, group, real, gen, *, name=None, doc_vid=None,
                 peer=None):
        self.kind = kind
        self.group = group
        self.real = real  # node-side integer handle
        self.gen = gen  # group generation the handle was minted under
        self.name = name  # durable doc name (re-resolvable)
        self.doc_vid = doc_vid  # sessions: their document's vid
        self.peer = peer  # attached sessions: peer name (re-attachable)


class _Group:
    """One shard group: an ordered list of node addresses + leadership."""

    def __init__(self, idx: int, addrs: List[str]):
        self.idx = idx
        self.addrs = list(addrs)
        self.leader = addrs[0]
        self.gen = 0  # bumps on every failover; stale handles re-resolve
        self.stream: Optional[str] = None  # leader's replication stream id
        self.up = threading.Event()
        self.up.set()
        self.failing = False  # a failover for this group is in flight
        # overload advertisement from the leader's heartbeat: lowest
        # priority rank it is shedding (5 = nothing), its backoff hint,
        # and when the advertisement was read (stale ones are ignored)
        self.shed_class = 5
        self.shed_retry_ms = 0
        self.shed_ts = 0.0


class _DataConn:
    """One pooled router->node connection: pipelined, id-rewritten."""

    def __init__(self, addr: str):
        host, _, port = addr.rpartition(":")
        self.addr = addr
        self.sock = socket.create_connection((host, int(port)), timeout=10)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.f = self.sock.makefile("r")
        self.wlock = threading.Lock()
        self.plock = threading.Lock()
        self.pending: Dict[int, Tuple] = {}  # nid -> (conn, rid, ctx)
        self.nid = 0
        self.dead = False

    def send(self, req: dict, conn, rid, ctx) -> None:
        with self.plock:
            if self.dead:
                raise OSError("node connection is dead")
            self.nid += 1
            nid = self.nid
            # the method rides along so the death sweep can label its
            # Unavailable answers (cluster.unavailable{method})
            self.pending[nid] = (conn, rid, ctx, req.get("method"))
        req["id"] = nid
        data = (json.dumps(req) + "\n").encode("utf-8")
        try:
            with self.wlock:
                self.sock.sendall(data)
        except Exception as e:
            with self.plock:
                swept = self.pending.pop(nid, None) is None
            if swept:
                # the reader observed the death first and already
                # answered this request from the pending sweep — a
                # second reply would desynchronize the client
                raise _AlreadyAnswered() from e
            raise

    def close(self) -> None:
        self.dead = True
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self.sock.close()


class ClusterRouter:
    """See module docstring."""

    def __init__(
        self,
        groups: List[List[str]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        conns_per_node: int = 2,
        heartbeat: Optional[float] = None,
        miss_limit: int = 3,
        vnodes: int = 64,
    ):
        if not groups or any(not g for g in groups):
            raise ValueError("router needs at least one non-empty group")
        self._groups = [_Group(i, g) for i, g in enumerate(groups)]
        self._ring = HashRing(list(range(len(groups))), vnodes=vnodes)
        self._overrides: Dict[str, int] = {}  # migrated doc name -> group
        self._migrating: Dict[str, threading.Event] = {}
        self._host = host
        self._port = port
        self._conns_per_node = max(1, conns_per_node)
        self.heartbeat = (
            heartbeat if heartbeat is not None
            else _env_float("AUTOMERGE_TPU_CLUSTER_HEARTBEAT", 1.0)
        )
        self.miss_limit = max(1, miss_limit)
        self.unavailable_timeout = _env_float(
            "AUTOMERGE_TPU_CLUSTER_ACK_TIMEOUT", 30.0)
        self._lock = threading.RLock()
        self._vh: Dict[int, _VHandle] = {}
        self._durable_vids: Dict[str, int] = {}  # doc name -> vid
        self._next_vid = 1
        self._links: Dict[str, List[_DataConn]] = {}  # addr -> pool
        self._listener: Optional[socket.socket] = None
        self._shutdown = threading.Event()
        self._failover_wanted: Dict[int, bool] = {}
        self._monitor_wake = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        assert self._listener is not None, "router not started"
        return self._listener.getsockname()[:2]

    def start(self) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._port))
        ls.listen(128)
        self._listener = ls
        for name, target in (
            ("router-accept", self._accept_loop),
            ("router-monitor", self._monitor_loop),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def serve_forever(self) -> None:
        if self._listener is None:
            self.start()
        self._shutdown.wait()
        self.stop()

    def stop(self) -> None:
        self._shutdown.set()
        self._monitor_wake.set()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
            self._listener = None
        with self._lock:
            pools = [c for pool in self._links.values()
                     for c in pool if c is not None]
            self._links.clear()
        for c in pools:
            c.close()

    # -- placement -----------------------------------------------------------

    def group_for_name(self, name: str) -> _Group:
        with self._lock:
            idx = self._overrides.get(name)
        if idx is None:
            idx = self._ring.member_for(name)
        return self._groups[idx]

    def _anchor_group(self, cid: int) -> _Group:
        # connection-scoped state (plain docs, bare sync states) pins to
        # one group so cross-handle methods (merge, generateSyncMessage)
        # land on a single node
        return self._groups[
            self._ring.member_for(f"__conn__{cid}")
        ]

    # -- node connections ----------------------------------------------------

    def _data_conn(self, addr: str, affinity: int) -> _DataConn:
        with self._lock:
            pool = self._links.get(addr)
            if pool is None:
                pool = self._links[addr] = []
            slot = affinity % self._conns_per_node
            while len(pool) <= slot:
                pool.append(None)
            conn = pool[slot]
            if conn is not None and not conn.dead:
                return conn
        conn = _DataConn(addr)
        t = threading.Thread(
            target=self._node_reader, args=(conn,),
            name=f"router-node-{addr}", daemon=True,
        )
        with self._lock:
            pool = self._links.setdefault(addr, [])
            while len(pool) <= slot:
                pool.append(None)
            if pool[slot] is not None and not pool[slot].dead:
                conn.close()
                return pool[slot]
            pool[slot] = conn
        t.start()
        return conn

    def _admin(self, addr: str, method: str, params: dict,
               timeout: float = 10.0) -> dict:
        """One synchronous request on a fresh short-lived connection —
        the control path (status polls, promotion, re-resolution,
        migration) must not share fate with pipelined data traffic."""
        host, _, port = addr.rpartition(":")
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            line = json.dumps(
                {"id": 1, "method": method, "params": params}) + "\n"
            sock.sendall(line.encode("utf-8"))
            f = sock.makefile("r")
            raw = f.readline()
        if not raw:
            raise OSError(f"{addr}: connection closed during {method}")
        resp = json.loads(raw)
        if "error" in resp:
            err = resp["error"]
            raise RuntimeError(f"{err.get('type')}: {err.get('message')}")
        return resp.get("result") or {}

    # -- client side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        cid = 0
        while not self._shutdown.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            with contextlib.suppress(OSError):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            cid += 1
            obs.count("router.accepted")
            threading.Thread(
                target=self._client_loop, args=(cid, sock),
                name=f"router-client-{cid}", daemon=True,
            ).start()

    def _client_loop(self, cid: int, sock: socket.socket) -> None:
        wlock = threading.Lock()

        def reply(payload: dict) -> None:
            data = (json.dumps(payload) + "\n").encode("utf-8")
            try:
                with wlock:
                    sock.sendall(data)
            except OSError:
                pass

        conn = (sock, wlock, reply)
        f = sock.makefile("rb")
        try:
            while not self._shutdown.is_set():
                raw = f.readline(32 << 20)
                if not raw:
                    return
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise ValueError("request must be a JSON object")
                except Exception as e:
                    reply({"id": None, "error": {
                        "type": "ParseError", "message": str(e),
                        "retriable": False}})
                    continue
                # deadline propagation: note when the budget-carrying
                # request entered the router, so the forwarded deadline
                # can be rewritten net of router queueing/waits
                if "deadlineMs" in req:
                    req["_arrival"] = obs.now()
                try:
                    self._route(cid, conn, req)
                except _RouteError as e:
                    obs.count("router.errors", labels={"type": e.type})
                    if e.type == "Unavailable":
                        # failover-window error volume, by method — the
                        # measurable cost of an outage to clients
                        obs.count("cluster.unavailable", labels={
                            "method": str(req.get("method"))[:40]})
                    # every router-originated error states its retry
                    # semantics: Unavailable (outage windows) is
                    # retriable, handle/placement errors are not
                    err = {"type": e.type, "message": str(e),
                           "retriable": e.type == "Unavailable"}
                    reply({"id": req.get("id"), "error": err})
                except Exception as e:  # noqa: BLE001 — isolate clients
                    obs.count("router.errors",
                              labels={"type": type(e).__name__})
                    # non-_RouteError escapes are router-side infra
                    # mishaps (an admin call racing a failover, a dead
                    # pooled conn) — transient by nature, so retriable
                    reply({"id": req.get("id"), "error": {
                        "type": "RouterError", "message": str(e),
                        "retriable": True}})
        finally:
            with contextlib.suppress(Exception):
                f.close()
            with contextlib.suppress(OSError):
                sock.close()

    # -- routing -------------------------------------------------------------

    def _route(self, cid: int, conn, req: dict) -> None:
        method = req.get("method")
        reply = conn[2]
        if method == "shutdown":
            # the ack must leave before stop() sweeps the sockets closed
            reply({"id": req.get("id"), "result": None})
            self._shutdown.set()
            self._monitor_wake.set()
            return
        if method in _ROUTER_METHODS:
            reply(self._local(method, req))
            return
        # trace propagation: a client-supplied {"trace": {"t", "s"}}
        # parents the router's span into the client's chain and is
        # rewritten to name the ROUTER span as the node's parent — so
        # the proxied hop appears between client and leader in the
        # merged flight timeline. No trace field, no work.
        tr = req.get("trace")
        if isinstance(tr, dict):
            with obs.trace_scope(tr.get("t"), tr.get("s")):
                with obs.span("router.request",
                              labels={"method": str(method)[:40]}) as sp:
                    fwd = None
                    tid = obs.current_trace.get()
                    if tid is not None:
                        fwd = {"t": tid, "s": sp.span_id}
                    self._route_remote(cid, conn, req, trace=fwd)
            return
        with obs.span("router.request", labels={"method": str(method)[:40]}):
            self._route_remote(cid, conn, req)

    def _route_remote(self, cid: int, conn, req: dict, trace=None) -> None:
        method = req.get("method")
        rid = req.get("id")
        params = dict(req.get("params") or {})

        # 1. placement: which group must serve this request. A doc
        # mid-migration holds its traffic until the flip, and the group
        # is (re)computed AFTER the wait — the whole point of waiting is
        # that the answer may change
        name = None
        if method == "openDurable" or (
            method == "docDigest" and isinstance(params.get("name"), str)
        ):
            name = params.get("name")
            if not isinstance(name, str):
                raise _RouteError("ValueError", "openDurable requires name")
            self._await_migration(name)
            group = self.group_for_name(name)
            vh = None
        else:
            vh, group = self._params_group(cid, params)
            if vh is not None and vh.name is not None:
                self._await_migration(vh.name)
                group = self.group_for_name(vh.name)

        # 2. group availability (failover may be in flight)
        if not group.up.wait(timeout=self.unavailable_timeout):
            raise _RouteError(
                "Unavailable", f"group {group.idx} has no leader")

        # 2b. shed-mode: the leader's heartbeat advertised it is
        # refusing this priority class — answer Overloaded here instead
        # of burning a round trip on a guaranteed refusal. Stale
        # advertisements (no heartbeat for ~3 periods) are ignored.
        if group.shed_class < 5 and (
            obs.now() - group.shed_ts <= max(self.heartbeat * 3, 3.0)
        ):
            rank, cls = priority_class(method if isinstance(method, str)
                                       else "")
            if rank >= group.shed_class:
                obs.count("router.shed", labels={"class": cls})
                err = {
                    "type": "Overloaded",
                    "message": f"leader {group.leader} is shedding "
                               f"{cls} work",
                    "retriable": True,
                }
                if group.shed_retry_ms > 0:
                    err["retryAfterMs"] = group.shed_retry_ms
                conn[2]({"id": rid, "error": err})
                return

        # 3. re-resolve stale virtual handles (post-failover lazily)
        self._refresh_handles(params)

        # 4. rewrite handle params to node-side reals
        affinity = 0
        for fld in _HANDLE_PARAMS:
            v = params.get(fld)
            if isinstance(v, int):
                h = self._vh.get(v)
                if h is None:
                    raise _RouteError(
                        "InvalidHandle", f"unknown handle {v} in {fld!r}")
                params[fld] = h.real
                if fld in ("doc", "session"):
                    affinity = v

        # 5. response context: creation methods mint a virtual handle
        ctx = None
        if method in _CREATES:
            field, kind = _CREATES[method]
            doc_vid = req.get("params", {}).get("doc")
            peer = params.get("peer") if method == "syncSessionAttach" else None
            ctx = ("create", field, kind, group.idx, group.gen, name,
                   doc_vid, peer)
        elif method in _FREES:
            fld = {"free": "doc", "syncStateFree": "sync",
                   "syncSessionFree": "session"}[method]
            ctx = ("free", (req.get("params") or {}).get(fld))

        # 5b. deadline rewrite: forward the budget net of the time this
        # request spent inside the router (parse, migration/availability
        # waits). A budget that burned away entirely answers
        # DeadlineExceeded here — shipping it would only make the node
        # refuse it after a queue slot and a round trip.
        fwd_deadline = None
        dl = req.get("deadlineMs")
        if (isinstance(dl, (int, float)) and not isinstance(dl, bool)
                and dl > 0):
            arrival = req.get("_arrival")
            elapsed_ms = (
                (obs.now() - arrival) * 1000.0
                if isinstance(arrival, (int, float)) else 0.0
            )
            remaining = float(dl) - elapsed_ms
            if remaining <= 0:
                obs.count("router.deadline_expired")
                conn[2]({"id": rid, "error": {
                    "type": "DeadlineExceeded",
                    "message": "client deadline expired in the router",
                    "retriable": True,
                }})
                return
            fwd_deadline = max(1, int(remaining))

        # 6. ship on the leader's pooled connection
        try:
            out = {"method": method, "params": params}
            if fwd_deadline is not None:
                out["deadlineMs"] = fwd_deadline
            if trace is not None:
                out["trace"] = trace
            dconn = self._data_conn(group.leader, affinity)
            dconn.send(out, conn, rid, ctx)
        except _AlreadyAnswered:
            self._note_node_trouble(group, group.leader)
        except Exception as e:
            self._note_node_trouble(group, group.leader)
            raise _RouteError(
                "Unavailable", f"leader {group.leader}: {e}") from e

    def _params_group(self, cid: int, params: dict):
        """(vhandle, group) for a handle-bearing request — every handle
        must live in one group; bare requests pin to the anchor."""
        found = None
        for fld in _HANDLE_PARAMS:
            v = params.get(fld)
            if isinstance(v, int):
                h = self._vh.get(v)
                if h is None:
                    raise _RouteError(
                        "InvalidHandle", f"unknown handle {v} in {fld!r}")
                if found is not None and h.group != found.group:
                    raise _RouteError(
                        "CrossNode",
                        "handles live on different shard groups; co-locate "
                        "them (same durable-name hash) to combine them",
                    )
                found = h
        if found is not None:
            return found, self._groups[found.group]
        return None, self._anchor_group(cid)

    def _refresh_handles(self, params: dict) -> None:
        """After a failover bumped ``group.gen``, node-side handles died
        with the old leader: re-materialize them by name (docs) or by
        (doc, peer) attachment (sessions) on the new leader."""
        for fld in _HANDLE_PARAMS:
            v = params.get(fld)
            if not isinstance(v, int):
                continue
            h = self._vh.get(v)
            if h is None or h.gen == self._groups[h.group].gen:
                continue
            g = self._groups[h.group]
            if h.kind == "doc" and h.name is not None:
                res = self._admin(g.leader, "openDurable", {"name": h.name})
                h.real, h.gen = res["doc"], g.gen
            elif h.kind == "session" and h.peer is not None:
                doc_h = self._vh.get(h.doc_vid)
                if doc_h is None or doc_h.name is None:
                    raise _RouteError(
                        "Gone", "session's document did not survive failover")
                if doc_h.gen != g.gen:
                    res = self._admin(
                        g.leader, "openDurable", {"name": doc_h.name})
                    doc_h.real, doc_h.gen = res["doc"], g.gen
                res = self._admin(g.leader, "syncSessionAttach",
                                  {"doc": doc_h.real, "peer": h.peer})
                h.real, h.gen = res["session"], g.gen
            else:
                raise _RouteError(
                    "Gone",
                    f"{h.kind} handle {v} was lost with the failed node "
                    "(only named durable docs and attached sessions survive "
                    "failover)",
                )

    # -- node side -----------------------------------------------------------

    def _node_reader(self, dconn: _DataConn) -> None:
        try:
            while True:
                raw = dconn.f.readline()
                if not raw:
                    break
                # per-line fault isolation: one response that trips the
                # bookkeeping must not take down the whole pooled conn
                # (and every pending request on it) as collateral
                try:
                    resp = json.loads(raw)
                    with dconn.plock:
                        entry = dconn.pending.pop(resp.get("id"), None)
                    if entry is None:
                        continue
                    conn, rid, ctx, _method = entry
                    resp["id"] = rid
                    if ctx is not None and "error" not in resp:
                        self._apply_ctx(ctx, resp)
                    conn[2](resp)
                except Exception as e:  # noqa: BLE001 — isolate the line
                    obs.count("router.garbled_node_frames",
                              error=str(e)[:200])
        except Exception:
            pass
        finally:
            dconn.dead = True
            with dconn.plock:
                pending = list(dconn.pending.values())
                dconn.pending.clear()
            for conn, rid, _ctx, method in pending:
                obs.count("cluster.unavailable",
                          labels={"method": str(method)[:40]})
                conn[2]({"id": rid, "error": {
                    "type": "Unavailable",
                    "message": f"node {dconn.addr} went away mid-request",
                    "retriable": True,
                }})
            self._on_conn_death(dconn.addr)

    def _apply_ctx(self, ctx, resp: dict) -> None:
        if ctx[0] == "create":
            _, field, kind, gidx, gen, name, doc_vid, peer = ctx
            result = resp.get("result")
            if not isinstance(result, dict) or field not in result:
                return
            real = result[field]
            with self._lock:
                if name is not None and name in self._durable_vids:
                    # reopening an already-virtualized durable doc: keep
                    # the same vid (and refresh its real handle)
                    vid = self._durable_vids[name]
                    h = self._vh[vid]
                    h.real, h.gen = real, gen
                else:
                    vid = self._next_vid
                    self._next_vid += 1
                    self._vh[vid] = _VHandle(
                        kind, gidx, real, gen,
                        name=name, doc_vid=doc_vid, peer=peer)
                    if name is not None:
                        self._durable_vids[name] = vid
            result[field] = vid
        elif ctx[0] == "free":
            vid = ctx[1]
            with self._lock:
                h = self._vh.pop(vid, None)
                if h is not None and h.name is not None:
                    self._durable_vids.pop(h.name, None)

    def _on_conn_death(self, addr: str) -> None:
        for g in self._groups:
            if g.leader == addr and not self._shutdown.is_set():
                self._note_node_trouble(g, addr)

    def _note_node_trouble(self, group: _Group, addr: str) -> None:
        if group.leader == addr:
            self._failover_wanted[group.idx] = True
            self._monitor_wake.set()

    # -- failover ------------------------------------------------------------

    def _monitor_loop(self) -> None:
        misses = {g.idx: 0 for g in self._groups}
        while not self._shutdown.is_set():
            self._monitor_wake.wait(timeout=self.heartbeat)
            self._monitor_wake.clear()
            if self._shutdown.is_set():
                return
            for g in self._groups:
                if g.failing:
                    continue
                # a data-path death report only shortcuts the miss
                # accumulation — the liveness probe ALWAYS runs, so a
                # stale report about an already-replaced leader (its old
                # connections die during the freeze) can never trigger a
                # second failover against the healthy new one
                wanted = self._failover_wanted.pop(g.idx, False)
                try:
                    # the timeout floor matters: a leader mid-fsync-storm
                    # can stall longer than a tight heartbeat, and a
                    # spurious promotion (while survivable — quorum acks
                    # keep it lossless) churns the group
                    t0 = obs.now()
                    st = self._admin(
                        g.leader, "clusterStatus", {},
                        timeout=max(self.heartbeat * 2, 1.0))
                    t1 = obs.now()
                    # the liveness poll doubles as a clock-sync probe
                    # (RTT midpoint), so flight-merge can chain router ->
                    # leader -> follower onto one timeline
                    peer_now = st.get("now")
                    if isinstance(peer_now, (int, float)):
                        obs.flight.note_clock_sync(
                            st.get("nodeId") or g.leader, t0, t1, peer_now)
                    g.stream = st.get("stream") or g.stream
                    # shed-mode advertisement: stop routing sheddable
                    # classes at a leader that would only refuse them
                    adm = st.get("admission")
                    if isinstance(adm, dict):
                        try:
                            g.shed_class = int(adm.get("shedClass", 5))
                            g.shed_retry_ms = int(adm.get("retryAfterMs", 0))
                        except (TypeError, ValueError):
                            g.shed_class, g.shed_retry_ms = 5, 0
                    else:
                        g.shed_class, g.shed_retry_ms = 5, 0
                    g.shed_ts = t1
                    misses[g.idx] = 0
                    continue
                except Exception:
                    misses[g.idx] += 1
                    if not wanted and misses[g.idx] < self.miss_limit:
                        continue
                misses[g.idx] = 0
                self._failover(g)

    def _failover(self, group: _Group) -> None:
        """Promote the longest durable acked prefix; rewire; unfreeze."""
        t0 = time.monotonic()
        group.failing = True
        group.up.clear()
        dead = group.leader
        obs.count("cluster.leader_deaths")
        candidates = []
        try:
            statuses = {}
            for addr in group.addrs:
                if addr == dead:
                    continue
                try:
                    st = self._admin(addr, "clusterStatus", {}, timeout=5.0)
                except Exception:
                    continue
                statuses[addr] = st
                total = 0
                for info in (st.get("docs") or {}).values():
                    cur = info.get("cursor")
                    if cur and (group.stream is None
                                or cur.get("stream") == group.stream):
                        total += int(cur.get("lsn", 0))
                candidates.append((total, addr))
            if not candidates:
                return  # stays frozen; the finally below schedules a retry
            candidates.sort()
            _best_lsn, winner = candidates[-1]
            res = self._admin(winner, "clusterPromote", {}, timeout=30.0)
            group.leader = winner
            group.stream = res.get("stream")
            group.gen += 1
            # per-doc streams ship independently, so cursor SUMS can be
            # incomparable — a follower behind on one doc can out-sum
            # the only holder of another doc's acked writes. Union every
            # other reachable follower's state into the winner (changes
            # deduplicate by hash — a CRDT merge is always safe): any
            # follower that confirmed a quorum ack either is reachable
            # here or was a second simultaneous failure.
            self._reconcile(winner, statuses)
            for addr in group.addrs:
                if addr in (dead, winner):
                    continue
                with contextlib.suppress(Exception):
                    self._admin(winner, "clusterReplicateTo",
                                {"addr": addr}, timeout=10.0)
            # the dead leader leaves the membership (no point probing a
            # corpse on later failovers); a restarted incarnation
            # re-enters through clusterJoin
            if dead in group.addrs:
                group.addrs.remove(dead)
            # drop stale pooled conns to the dead node
            with self._lock:
                pool = self._links.pop(dead, [])
            for c in pool:
                if c is not None:
                    c.close()
            group.up.set()
            # trouble reports that accumulated about the OLD leader while
            # we were failing over are resolved by this promotion
            self._failover_wanted.pop(group.idx, None)
            dt = time.monotonic() - t0
            obs.observe("cluster.failover_latency", dt)
            obs.count("cluster.failovers")
            obs.event("cluster.failover", group=group.idx, dead=dead,
                      promoted=winner, seconds=round(dt, 3))
            # a failover IS a postmortem moment: snapshot the flight
            # rings now (no-op unless a flight dir is installed)
            obs.flight.dump(reason="failover")
        finally:
            group.failing = False
            if not group.up.is_set():
                # promotion did not complete (nobody reachable, or the
                # promote call itself failed): stay frozen; the wanted
                # flag makes the next heartbeat tick retry (no wake —
                # an immediate retry against dead nodes would spin)
                self._failover_wanted[group.idx] = True

    def _reconcile(self, winner: str, statuses: Dict[str, dict]) -> None:
        """Union other followers' documents into the promoted winner
        wherever their durable cursor is not clearly dominated (ahead on
        LSN, or on a different stream — incomparable). Harvested saves
        merge through ``migrateIn``: already-known changes deduplicate,
        missing acked writes land, and the winner's own replication then
        fans the union back out."""
        wdocs = (statuses.get(winner) or {}).get("docs") or {}
        for addr, st in statuses.items():
            if addr == winner:
                continue
            for name, info in (st.get("docs") or {}).items():
                cur = info.get("cursor") or {}
                wcur = (wdocs.get(name) or {}).get("cursor") or {}
                dominated = (
                    name in wdocs
                    and cur.get("stream") == wcur.get("stream")
                    and int(cur.get("lsn", 0)) <= int(wcur.get("lsn", 0))
                )
                if dominated:
                    continue
                try:
                    harvest = self._admin(addr, "replHarvest",
                                          {"name": name}, timeout=30.0)
                    self._admin(winner, "migrateIn", {
                        "name": name, "snapshot": harvest["snapshot"],
                    }, timeout=60.0)
                    obs.count("cluster.reconcile_harvests")
                except Exception as e:  # noqa: BLE001 — best effort past
                    # the quorum guarantee; count loudly, keep promoting
                    obs.count("cluster.reconcile_error",
                              error=str(e)[:200])

    # -- router-local methods ------------------------------------------------

    def _local(self, method: str, req: dict) -> dict:
        rid = req.get("id")
        p = req.get("params") or {}
        try:
            if method == "metrics":
                if p.get("format") == "json":
                    return {"id": rid, "result": {
                        "format": "json", "metrics": obs.snapshot()}}
                return {"id": rid, "result": {
                    "format": "prometheus",
                    "body": obs.render_prometheus()}}
            if method == "clusterMetrics":
                return {"id": rid, "result": self._cluster_metrics()}
            if method == "clusterInfo":
                return {"id": rid, "result": {
                    "groups": [
                        {"idx": g.idx, "addrs": g.addrs,
                         "leader": g.leader, "gen": g.gen,
                         "up": g.up.is_set()}
                        for g in self._groups
                    ],
                    "overrides": dict(self._overrides),
                    "handles": len(self._vh),
                }}
            if method == "clusterMigrate":
                return {"id": rid, "result": self._migrate(
                    p["name"], int(p["to"]))}
            if method == "clusterJoin":
                return {"id": rid, "result": self._join(
                    int(p["group"]), p["addr"])}
            if method == "clusterAdvise":
                return {"id": rid, "result": self._cluster_advise(p)}
            raise ValueError(f"unknown router method {method}")
        except Exception as e:  # noqa: BLE001 — answer, never die
            return {"id": rid, "error": {
                "type": type(e).__name__, "message": str(e)}}

    def _cluster_metrics(self) -> dict:
        """Fan the ``metrics`` RPC out to every node (leaders AND
        followers) and merge the expositions into one family set with a
        ``node`` label per sample — the single scrape endpoint for the
        whole cluster. The router's own registry joins as
        ``node="router"``; unreachable nodes are reported, not fatal."""
        from ..obs.metrics import merge_prometheus

        bodies = {"router": obs.render_prometheus()}
        unreachable = []
        out_lock = threading.Lock()

        def scrape(addr: str) -> None:
            try:
                res = self._admin(addr, "metrics", {}, timeout=5.0)
                with out_lock:
                    bodies[addr] = res.get("body") or ""
            except Exception as e:  # noqa: BLE001 — scrape what's up
                with out_lock:
                    unreachable.append(
                        {"node": addr, "error": str(e)[:200]})

        # scrape nodes concurrently: one hung node costs the whole
        # scrape its OWN timeout, not timeout x cluster size
        threads = [
            threading.Thread(target=scrape, args=(addr,), daemon=True)
            for g in self._groups for addr in g.addrs
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        # snapshot under the lock: a straggler thread past the deadline
        # must not mutate what merge_prometheus is iterating, and it
        # reports as unreachable rather than vanishing
        with out_lock:
            bodies_snap = dict(bodies)
            unreachable_snap = list(unreachable)
        answered = set(bodies_snap) | {u["node"] for u in unreachable_snap}
        for g in self._groups:
            for addr in g.addrs:
                if addr not in answered:
                    unreachable_snap.append(
                        {"node": addr, "error": "scrape deadline exceeded"})
        return {
            "format": "prometheus",
            "body": merge_prometheus(bodies_snap),
            "nodes": sorted(bodies_snap),
            "unreachable": unreachable_snap,
        }

    def _cluster_advise(self, p: dict) -> dict:
        """Gather each group leader's heat table, staleness report and
        per-doc store tiers, then run the pure placement advisor
        (cluster/advisor.py) over the combined snapshot. Report-only:
        the answer ranks and explains, actuation is the caller's call.
        Unreachable or partial telemetry shrinks the rule set instead
        of failing the request."""
        from . import advisor

        groups_out = []
        for g in self._groups:
            entry: dict = {"group": g.idx, "leader": g.leader}
            try:
                entry["heat"] = self._admin(
                    g.leader, "heatStatus", {}, timeout=5.0)
            except Exception as e:  # noqa: BLE001 — advise on what's up
                entry["error"] = str(e)[:200]
            try:
                st = self._admin(
                    g.leader, "clusterStatus", {}, timeout=5.0)
                entry["staleness"] = st.get("staleness") or {}
            except Exception:  # noqa: BLE001
                pass
            try:
                ss = self._admin(
                    g.leader, "storeStatus", {"docs": True}, timeout=5.0)
                entry["tiers"] = {
                    name: info.get("tier")
                    for name, info in (ss.get("docs") or {}).items()
                    if isinstance(info, dict)
                }
            except Exception:  # noqa: BLE001 — not every node runs a store
                pass
            groups_out.append(entry)
        kwargs = {}
        for key, snake, cast in (
            ("maxRecommendations", "max_recommendations", int),
            ("imbalanceRatio", "imbalance_ratio", float),
            ("hotFrac", "hot_frac", float),
            ("stalenessThreshold", "staleness_threshold", float),
        ):
            v = p.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                kwargs[snake] = cast(v)
        advice = advisor.advise({"groups": groups_out}, **kwargs)
        if p.get("snapshot"):
            advice["snapshot"] = {"groups": groups_out}
        if p.get("format") == "text":
            advice["text"] = advisor.render_text(advice)
        return advice

    def _join(self, gidx: int, addr: str) -> dict:
        """Admit a (re)joined node into a group as a follower: future
        failovers consider it, and the current leader starts shipping to
        it immediately."""
        if not (0 <= gidx < len(self._groups)):
            raise ValueError(f"no group {gidx}")
        g = self._groups[gidx]
        if addr not in g.addrs:
            g.addrs.append(addr)
        self._admin(g.leader, "clusterReplicateTo", {"addr": addr},
                    timeout=10.0)
        obs.count("cluster.joins")
        return {"group": gidx, "addrs": list(g.addrs)}

    # -- live shard migration ------------------------------------------------

    def _await_migration(self, name: str) -> None:
        ev = self._migrating.get(name)
        if ev is not None and not ev.wait(timeout=self.unavailable_timeout):
            raise _RouteError(
                "Unavailable", f"migration of {name!r} did not finish")

    def _fence_doc(self, group: _Group, name: str) -> None:
        """Flush the in-flight pipeline for one document: a cheap
        affinity-matched request down the same pooled connection; its
        response proves every earlier frame for the doc was read and
        executed by the node's per-doc shard queue."""
        with self._lock:
            vid = self._durable_vids.get(name)
            h = self._vh.get(vid) if vid is not None else None
        if h is None:
            return  # never routed through us: nothing can be in flight
        done = threading.Event()
        sentinel = (None, None, lambda _resp: done.set())
        try:
            dconn = self._data_conn(group.leader, vid)
            # docFence, not heads: the fence must not HYDRATE a cold
            # document — keeping it cold is what makes it the cheap
            # migration source this fence is clearing the way for
            dconn.send({"method": "docFence", "params": {"doc": h.real}},
                       sentinel, 0, None)
        except Exception:
            return  # conn is dead: nothing pipelined survives on it
        if not done.wait(timeout=self.unavailable_timeout):
            raise _RouteError(
                "Unavailable", f"fence for {name!r} never drained")

    def _migrate(self, name: str, to: int) -> dict:
        if not (0 <= to < len(self._groups)):
            raise ValueError(f"no group {to}")
        src = self.group_for_name(name)
        dst = self._groups[to]
        if src.idx == dst.idx:
            return {"migrated": False, "group": to}
        t0 = time.monotonic()
        # phase 1: snapshot while the doc keeps serving on the source
        out = self._admin(src.leader, "migrateOut", {"name": name},
                          timeout=60.0)
        # phase 2: pause the doc, ship the tail since the snapshot
        ev = threading.Event()
        self._migrating[name] = ev
        try:
            # fence the data path: new requests are paused above, but
            # frames already pipelined toward the source may not have
            # been read yet — a write acked after the tail is read would
            # be lost. A sentinel request through the SAME pooled conn
            # (and, via doc affinity, the same node-side shard queue)
            # proves everything ahead of it has fully executed;
            # migrateTail then queues strictly after the fence.
            self._fence_doc(src, name)
            if out.get("cold"):
                # cold source: the phase-1 bytes could have gone stale if
                # an access hydrated the doc in between — re-read under
                # the pause (cheap: file reads, no residency rebuild).
                # Still cold => snapshot+tail came back whole in `data`
                # and there is no live stream to tail.
                out = self._admin(src.leader, "migrateOut", {"name": name},
                                  timeout=60.0)
            if out.get("cold"):
                tail = {"data": out.get("data") or "", "lsn": out["lsn"],
                        "dataCodec": out.get("dataCodec")}
            else:
                try:
                    tail = self._admin(
                        src.leader, "migrateTail",
                        {"name": name, "since": out["lsn"]}, timeout=60.0)
                except Exception:
                    # tail trimmed (or the doc demoted mid-pause):
                    # re-snapshot under the pause (now final)
                    out = self._admin(src.leader, "migrateOut",
                                      {"name": name}, timeout=60.0)
                    tail = {"data": out.get("data") or "",
                            "lsn": out["lsn"],
                            "dataCodec": out.get("dataCodec")}
            # payload codec fields ride along verbatim: the source node
            # decides whether each blob shipped compressed (_wire_blob)
            # and the target's migrateIn decodes by codec tag
            self._admin(dst.leader, "migrateIn", {
                "name": name, "snapshot": out["snapshot"],
                "snapshotCodec": out.get("snapshotCodec"),
                "data": tail.get("data") or "",
                "dataCodec": tail.get("dataCodec"),
                "meta": out.get("meta") or {},
            }, timeout=60.0)
            with self._lock:
                self._overrides[name] = to
                vid = self._durable_vids.get(name)
                if vid is not None:
                    h = self._vh[vid]
                    h.group = dst.idx
                    h.gen = dst.gen - 1  # force re-resolution on next use
                    # sessions attached to the migrated doc move with it:
                    # left behind they would route to the source node,
                    # whose copy migrateRelease is about to close. The
                    # stale gen makes the next use re-attach by
                    # (doc, peer) on the destination leader — the carried
                    # sync/<peer> meta resumes them via the epoch
                    # handshake.
                    for sh in self._vh.values():
                        if sh.kind == "session" and sh.doc_vid == vid:
                            sh.group = dst.idx
                            sh.gen = dst.gen - 1
            self._admin(src.leader, "migrateRelease", {"name": name},
                        timeout=30.0)
        finally:
            ev.set()
            self._migrating.pop(name, None)
        dt = time.monotonic() - t0
        obs.observe("cluster.migration_latency", dt)
        obs.count("cluster.migrations")
        return {"migrated": True, "group": to, "seconds": round(dt, 4)}


class _AlreadyAnswered(Exception):
    """The node reader's death sweep already answered this request."""


class _RouteError(Exception):
    def __init__(self, type_: str, message: str):
        super().__init__(message)
        self.type = type_


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="automerge_tpu_torch.cluster.router",
        description="consistent-hash router + failover monitor over "
                    "cluster node groups",
    )
    ap.add_argument("--listen", metavar="HOST:PORT", default="127.0.0.1:0")
    ap.add_argument(
        "--group", action="append", required=True, metavar="ADDR,ADDR,...",
        help="one shard group: comma-separated node addresses, leader "
             "first (repeatable)",
    )
    ap.add_argument("--heartbeat", type=float, default=None,
                    help="leader liveness poll interval in seconds "
                         "(default AUTOMERGE_TPU_CLUSTER_HEARTBEAT or 1.0)")
    ap.add_argument("--miss-limit", type=int, default=3,
                    help="consecutive missed heartbeats before failover")
    ap.add_argument("--flight-dir", metavar="DIR", default=None,
                    help="dump the flight recorder to DIR on "
                         "exit/failover (default AUTOMERGE_TPU_FLIGHT_DIR)")
    args = ap.parse_args(argv)
    import os

    flight_dir = args.flight_dir or os.environ.get("AUTOMERGE_TPU_FLIGHT_DIR")
    if flight_dir:
        obs.flight.install(flight_dir, node_id=f"router-{os.getpid()}")
    host, _, port = args.listen.rpartition(":")
    groups = [[a.strip() for a in g.split(",") if a.strip()]
              for g in args.group]
    router = ClusterRouter(
        groups, host=host or "127.0.0.1", port=int(port),
        heartbeat=args.heartbeat, miss_limit=args.miss_limit,
    )
    router.start()
    print(f"routing on {router.address}", file=sys.stderr, flush=True)
    router.serve_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
