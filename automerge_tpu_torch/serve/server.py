"""Socket transport for the JSON-RPC frontend: concurrent serving.

``SocketRpcServer`` exposes the exact stdio protocol (line-delimited
JSON, same method surface, same ``max_request_bytes`` framing
discipline) over TCP or a unix-domain socket, with real concurrency:

* a listener thread accepts connections; each connection gets a reader
  thread that parses frames and routes them;
* requests with document affinity go to the per-document single-writer
  shard pool (serve/shards.py): same-document requests execute in
  arrival order on one worker, different documents run in parallel;
* requests without document affinity (``create``, ``load``,
  ``configure``, ``metrics``, ``syncState*``) execute inline on the
  connection thread — they only touch the handle tables, which the
  ``RpcServer`` guards with its registry lock;
* a full shard queue answers immediately with a ``Backpressure`` error
  (``rpc.errors{type=Backpressure}``) instead of buffering unboundedly —
  the client owns the retry.

Ordering contract: responses to the SAME document arrive in request
order; responses across documents (or for affinity-free methods) may
interleave. Clients match responses by ``id``, exactly as the JSON-RPC
shape always allowed.

Group commit: a worker drains up to ``max_batch`` queued requests for
one document in a single grab and executes them inside the durable
document's ``ack_scope`` — every journal append in the batch rides ONE
policy fsync, and no response is written until that fsync has returned
(the ack is durable, just amortized; ``group_commit.batch_size`` in the
journal records how many appends each physical fsync covered). Runs of
``receiveSyncMessage`` / ``syncSessionReceive`` frames for the same
document additionally coalesce their resident-device feed into a single
``DeviceDoc.apply_batches`` call.

Env knobs (all overridable by constructor arguments):

* ``AUTOMERGE_TPU_SERVE_WORKERS``      worker pool size (default 8)
* ``AUTOMERGE_TPU_SERVE_QUEUE_DEPTH``  per-document queue bound (128)
* ``AUTOMERGE_TPU_SERVE_BATCH``        max requests per drain (16)

Run: ``python -m automerge_tpu_torch.rpc --socket HOST:PORT`` or
``--unix PATH``; a ``shutdown`` request from any connection stops the
whole server after flushing durable documents, exactly like EOF does in
stdio mode.

The device: ``SocketRpcServer(..., device=None)`` serves every document
on ``device`` (None: the card; without a GPU the constructor raises),
and its ``CrossDocBatcher`` launches there. Whether a drained feed rides
the batcher is decided by the document's mirror
(``CrossDocBatcher.active(mirror)``: under ``AUTOMERGE_TPU_SERVE_BATCHED=
auto`` a mirror on a CUDA device batches, a CPU one resolves its own
delta). A failed feed of a coalesced run is counted
(``sync.device_feed_error``) and answers every request of the run with
the error, where the JAX package's server counts it and acks.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..obs import prof
from ..ops import batched as _batched
from ..ops.batched import CrossDocBatcher
from ..device import resolve_device
from ..rpc import RpcServer, deadline_response, request_expired
from .admission import AdmissionController, Overloaded
from .shards import QueueFull, ShardPool

_OPEN_DURABLE_KEY = "__open_durable__"  # serializes name-cache races

# methods whose frames coalesce when adjacent in a drain (same doc, same
# sync/session handle): their device feed batches into one apply_batches
_COALESCE_METHODS = ("receiveSyncMessage", "syncSessionReceive")

# methods that must NOT hydrate a cold document before executing: they
# either retire it (free), or exist precisely because the document is
# cold (the migration source path ships a cold doc's on-disk bytes with
# no residency rebuild — hydrating it first would defeat that)
_NO_HYDRATE_METHODS = frozenset(
    {"free", "docFence", "migrateOut", "migrateTail", "migrateRelease"}
)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _run_trace_links(run) -> list:
    """Span links for a coalesced run: the wire trace context of every
    request the shared span covers (a coalesced receive executes many
    clients' frames under ONE span — links keep each attributable).
    Sanitization (and the 16-entry cap) is obs.decode_wire_traces' —
    the one place the wire trace-pair contract lives."""
    pairs = [
        [tr.get("t"), tr.get("s")]
        for _conn, req in run
        if isinstance(tr := req.get("trace"), dict)
    ]
    return obs.decode_wire_traces(pairs)


class _Conn:
    """One client connection: socket + serialized writes."""

    __slots__ = ("sock", "peer", "wlock", "alive")

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.peer = peer
        self.wlock = threading.Lock()
        self.alive = True

    def send(self, payload: str) -> None:
        """Write one response line; a dead peer is counted, never raised."""
        data = payload.encode("utf-8")
        try:
            with self.wlock:
                self.sock.sendall(data)
            obs.count("rpc.bytes_out", n=len(data))
        except Exception as e:
            if self.alive:
                self.alive = False
                obs.count("rpc.errors",
                          labels={"method": "transport", "type": "transport"})
                obs.event("rpc.transport_death", stage="write",
                          peer=self.peer, error=str(e))

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class SocketRpcServer:
    """The concurrent serving layer over one shared ``RpcServer`` state."""

    def __init__(
        self,
        rpc: Optional[RpcServer] = None,
        *,
        host: Optional[str] = None,
        port: int = 0,
        unix_path: Optional[str] = None,
        workers: Optional[int] = None,
        max_queue: Optional[int] = None,
        max_batch: Optional[int] = None,
        durable_dir: Optional[str] = None,
        device=None,
    ):
        if rpc is None:
            # the card unless asked otherwise: no GPU raises before any
            # thread or socket exists
            device = resolve_device(device)
        if (host is None) == (unix_path is None):
            raise ValueError("exactly one of host or unix_path is required")
        self.rpc = rpc or RpcServer(durable_dir=durable_dir, device=device)
        # durable docs opened by a concurrent server compact off the ack
        # path (background thread + per-doc lock)
        self.rpc.serve_background_compact = True
        self._host = host
        self._port = port
        self._unix_path = unix_path
        self._listener: Optional[socket.socket] = None
        self._conns: Dict[int, _Conn] = {}
        self._conns_lock = threading.Lock()
        self._next_conn = 1
        self._shutdown = threading.Event()
        self._stopped = threading.Event()
        self._stop_lock = threading.Lock()
        self._ack_threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        # per-doc execution locks for plain (non-durable) documents; a
        # durable document supplies its own (shared with its background
        # compactor). Only ``merge`` ever takes two at once — always in
        # sorted handle order, so the acquisition order is global.
        self._plain_locks: Dict[int, threading.RLock] = {}
        self._plain_locks_guard = threading.Lock()
        self.pool = ShardPool(
            self._execute_batch,
            workers=workers or _env_int("AUTOMERGE_TPU_SERVE_WORKERS", 8),
            max_queue=max_queue
            or _env_int("AUTOMERGE_TPU_SERVE_QUEUE_DEPTH", 128),
            max_batch=max_batch or _env_int("AUTOMERGE_TPU_SERVE_BATCH", 16),
            name="rpc-worker",
        )
        # cross-document device-merge batcher: workers draining DIFFERENT
        # documents in the same drain cycle share ONE kernel launch for
        # their coalesced device feeds (AUTOMERGE_TPU_SERVE_BATCHED=
        # 1|0|auto; auto batches only mirrors on a CUDA device — on the
        # CPU the per-doc host delta resolution is the fast path). The
        # packed launches run on the server's device. The early-wake
        # threshold is capped at the POOL SIZE: at most `workers` docs can
        # ever be draining at once, so a full complement of submitters
        # wakes the flush leader immediately instead of every drain
        # sleeping out the whole batch window. Generations at least
        # AUTOMERGE_TPU_PIPELINE_MIN_DOCS wide flush as two overlapped
        # half-launches (the drain pipeline; see batched.CrossDocBatcher)
        # — submitters still block until their half is collected. The
        # knobs keep the JAX package's names and defaults; the port's
        # batcher takes them from its caller, here
        n_workers = len(self.pool.workers)
        self.batcher = CrossDocBatcher(
            window_ms=_env_float(
                "AUTOMERGE_TPU_BATCH_WINDOW_MS", _batched.BATCH_WINDOW_MS),
            max_docs=min(
                _env_int("AUTOMERGE_TPU_BATCH_DOCS", 32), n_workers
            ),
            mode=os.environ.get(
                "AUTOMERGE_TPU_SERVE_BATCHED", _batched.SERVE_BATCHED),
            device=self.rpc.device,
        )
        self.batcher.pipeline_min_docs = int(_env_float(
            "AUTOMERGE_TPU_PIPELINE_MIN_DOCS", _batched.PIPELINE_MIN_DOCS))
        # overload resilience: one per-node admission controller scores
        # load from the pool's dequeue waits + utilization, the store's
        # hydration/RSS pressure, sheds by priority class past the soft
        # limits, and runs the brownout state machine (which widens the
        # batcher window under sustained pressure). The rpc backref lets
        # clusterStatus advertise shed-mode on the heartbeat.
        self.admission = AdmissionController(
            pool=self.pool, store=self.rpc.store, batcher=self.batcher
        )
        self.pool.wait_observer = self.admission.note_wait
        self.rpc.admission = self.admission

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int] | str:
        """Bound address — (host, port) for TCP (resolves port 0), the
        path for unix sockets."""
        if self._unix_path is not None:
            return self._unix_path
        assert self._listener is not None, "server not started"
        return self._listener.getsockname()[:2]

    def start(self) -> None:
        if self._unix_path is not None:
            # a stale socket file from a dead server blocks bind; remove
            # only if nothing is listening on it
            if os.path.exists(self._unix_path):
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.connect(self._unix_path)
                except OSError:
                    os.unlink(self._unix_path)
                else:
                    probe.close()
                    raise OSError(
                        f"socket {self._unix_path} already has a listener"
                    )
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(self._unix_path)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((self._host, self._port))
        ls.listen(128)
        self._listener = ls
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True
        )
        self._accept_thread.start()
        # background integrity scrub (integrity.py): durable deployments
        # only — a handle-only server has no on-disk state to verify.
        # start() no-ops when AUTOMERGE_TPU_SCRUB=0 (the bench baseline)
        if self.rpc.durable_dir and self.rpc.scrubber is None:
            from ..integrity import Scrubber

            self.rpc.scrubber = Scrubber(self.rpc)
            self.rpc.scrubber.start()
        # history rings (obs/history.py): fixed-memory downsampled recent
        # past of the allowlisted gauges/counters, served by the
        # historyStatus RPC and dumped with flight recordings. start() is
        # idempotent and a no-op under AUTOMERGE_TPU_HISTORY=0
        from ..obs import history

        if history.enabled():
            history.start()

    def serve_forever(self) -> None:
        """start() + block until a ``shutdown`` request (or ``stop()``)."""
        if self._listener is None:
            self.start()
        try:
            self._shutdown.wait()
        finally:
            self.stop()
            # a shutdown REQUEST acks after the flush; the process must
            # not exit from under that in-flight response. A SECOND
            # concurrent shutdown's thread may still be registered but
            # unstarted at this instant — joining that raises, and its
            # conn dies with the process anyway
            for t in self._ack_threads:
                with contextlib.suppress(RuntimeError):
                    t.join(timeout=10)

    def stop(self) -> None:
        """Stop accepting, drain the pool, flush durable docs, close.
        Idempotent: the shutdown request, serve_forever's exit and an
        explicit call may all race here; one of them does the work and
        the rest wait for it."""
        self._shutdown.set()
        with self._stop_lock:
            if self._stopped.is_set():
                return
            self._stop_inner()
            self._stopped.set()

    def wait_stopped(self, timeout: Optional[float] = None) -> bool:
        """Block until a triggered shutdown has fully flushed and closed."""
        return self._stopped.wait(timeout)

    def _stop_inner(self) -> None:
        if self.rpc.scrubber is not None:
            self.rpc.scrubber.stop()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        self.pool.stop(drain=True)
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
        obs.gauge_set("serve.connections", 0)
        self.rpc.close_durables()
        if self._unix_path is not None and os.path.exists(self._unix_path):
            with contextlib.suppress(OSError):
                os.unlink(self._unix_path)

    # -- accept / read -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # unix sockets have no Nagle to disable
            conn = _Conn(sock, str(addr))
            with self._conns_lock:
                cid = self._next_conn
                self._next_conn += 1
                self._conns[cid] = conn
                n = len(self._conns)
            obs.count("serve.accepted")
            obs.gauge_set("serve.connections", n)
            threading.Thread(
                target=self._conn_loop, args=(cid, conn),
                name=f"rpc-conn-{cid}", daemon=True,
            ).start()

    def _conn_loop(self, cid: int, conn: _Conn) -> None:
        rpc = self.rpc
        handoff = False  # True when the shutdown thread owns the socket
        f = conn.sock.makefile("rb")
        try:
            while not self._shutdown.is_set():
                # the stdio framing discipline, byte-exact: bounded
                # readline, then drain (and discard) an overlong line's
                # tail in limit-sized chunks up to its newline
                limit = rpc.max_request_bytes + 1
                try:
                    raw = f.readline(limit)
                    if len(raw) >= limit and not raw.endswith(b"\n"):
                        while True:
                            tail = f.readline(limit)
                            if not tail or tail.endswith(b"\n"):
                                break
                except Exception as e:
                    if conn.alive and not self._shutdown.is_set():
                        obs.count("rpc.errors", labels={
                            "method": "transport", "type": "transport"})
                        obs.event("rpc.transport_death", stage="read",
                                  peer=conn.peer, error=str(e))
                    return
                if not raw:
                    return  # EOF: client done
                line = raw.decode("utf-8", errors="replace")
                req, early = rpc._parse_line(line)
                if early is not None:
                    conn.send(rpc._encode_response(early) + "\n")
                    continue
                if req is None:
                    continue  # blank line
                if req.get("method") == "shutdown":
                    # drain in-flight work and flush durable docs BEFORE
                    # answering: when the response lands, the journals'
                    # flocks are released and the server is reusable.
                    # Claim the socket, register AND START the ack thread
                    # BEFORE raising the shutdown flag — the moment it is
                    # set, a racing stop() sweeps _conns closed and
                    # serve_forever starts joining _ack_threads (joining
                    # a registered-but-unstarted thread raises). The
                    # thread's own stop() call sets the flag anyway; the
                    # explicit set below just makes wake-up prompt.
                    with self._conns_lock:
                        self._conns.pop(cid, None)
                    handoff = True
                    t = threading.Thread(
                        target=self._stop_then_ack,
                        args=(conn, req.get("id")),
                        name="rpc-shutdown", daemon=True,
                    )
                    self._ack_threads.append(t)
                    t.start()
                    self._shutdown.set()
                    return
                self._route(conn, req)
        finally:
            if not handoff:
                with contextlib.suppress(Exception):
                    f.close()
                conn.close()
                with self._conns_lock:
                    self._conns.pop(cid, None)
                    n = len(self._conns)
                obs.gauge_set("serve.connections", n)

    def _stop_then_ack(self, conn: _Conn, rid) -> None:
        """Full stop (drain + durable flush + flock release), then answer
        the shutdown request — the ack means the server is truly down.
        The caller already removed ``conn`` from the sweep set."""
        self.stop()
        conn.send(self.rpc._encode_response(
            {"id": rid, "result": None}) + "\n")
        conn.close()

    # -- routing -------------------------------------------------------------

    def _affinity(self, req: dict):
        """The shard key for a request, or None to execute inline."""
        params = req.get("params") or {}
        method = req.get("method")
        if method in ("openDurable", "durableReopen"):
            # no handle yet (or the handle is being replaced); one queue
            # serializes the name-cache check against concurrent opens
            # and reopens of the same name
            return _OPEN_DURABLE_KEY
        d = params.get("doc")
        if isinstance(d, int):
            return d
        s = params.get("session")
        if s is not None:
            sd = self.rpc._session_docs.get(s)
            if sd is not None:
                return sd
        return None

    def _bounded_method(self, req: dict) -> str:
        """The request's method if it is in the allowlist, else
        "unknown" — keeps error-counter labels bounded."""
        m = req.get("method")
        return m if isinstance(m, str) and m in self.rpc.METHODS else "unknown"

    def _route(self, conn: _Conn, req: dict) -> None:
        # admission-stage deadline gate: a request that arrived already
        # expired (or aged out in the accept path) is refused before it
        # consumes a queue slot
        if self.rpc.deadlines_enabled and request_expired(req):
            conn.send(self.rpc._encode_response(deadline_response(
                req.get("id"), self._bounded_method(req), "admission")) + "\n")
            return
        # admission control: shed the lowest-priority classes first once
        # the load score crosses their thresholds
        try:
            self.admission.admit(req.get("method") or "")
        except Overloaded as e:
            err = {"type": "Overloaded", "message": str(e),
                   "retriable": True}
            if e.retry_after_ms is not None:
                err["retryAfterMs"] = int(e.retry_after_ms)
            conn.send(self.rpc._encode_response(
                {"id": req.get("id"), "error": err}) + "\n")
            return
        key = self._affinity(req)
        if key is None:
            # affinity-free: handle tables only, safe on this thread
            conn.send(self.rpc._encode_response(self.rpc.handle(req)) + "\n")
            return
        try:
            self.pool.submit(key, (conn, req))
        except QueueFull as e:
            # retriable by contract: backpressure is a transient level,
            # and the reference client retry loop (clients/python) backs
            # off on exactly this flag
            conn.send(self.rpc._encode_response({
                "id": req.get("id"),
                "error": {"type": "Backpressure", "message": str(e),
                          "retriable": True},
            }) + "\n")

    # -- execution (worker threads) ------------------------------------------

    def _doc_locks(self, req: dict) -> List[threading.RLock]:
        """Execution locks for every doc the request touches, in sorted
        handle order (the global acquisition order — no deadlocks)."""
        params = req.get("params") or {}
        handles = set()
        d = params.get("doc")
        if isinstance(d, int):
            handles.add(d)
        if req.get("method") == "merge" and isinstance(params.get("other"), int):
            handles.add(params["other"])
        # session-only requests (poll/receive/stats) mutate their doc's
        # core directly — they need the SAME doc lock or a background
        # compaction snapshot could race the sync apply
        s = params.get("session")
        if s is not None:
            sd = self.rpc._session_docs.get(s)
            if sd is not None:
                handles.add(sd)
        locks = []
        for h in sorted(handles):
            doc = self.rpc._docs.get(h)
            lock = getattr(doc, "lock", None)  # durable docs carry their own
            if lock is None:
                with self._plain_locks_guard:
                    lock = self._plain_locks.setdefault(h, threading.RLock())
            locks.append(lock)
        return locks

    def _execute_batch(self, key, items) -> None:
        """Drain one document's batch: every request under the doc's
        lock(s), the whole batch under ONE durable ack scope, responses
        written only after the covering fsync. The whole drain is one
        profiler cycle (``drain.cycle_seconds`` / ``drain.docs``), so
        cycle reports anchor to real serve drains, not just bench
        drains."""
        t_cycle = time.perf_counter()
        doc_name = (
            self.rpc._handle_names.get(key) or f"doc{key}"
            if isinstance(key, int)
            else str(key)
        )
        with prof.cycle(kind="serve", doc=doc_name):
            self._execute_batch_inner(key, items)
        obs.observe("drain.cycle_seconds", time.perf_counter() - t_cycle)
        docs = {key} if isinstance(key, int) else set()
        for _conn, req in items:
            d = (req.get("params") or {}).get("doc")
            if isinstance(d, int):
                docs.add(d)
        obs.observe("drain.docs", max(len(docs), 1))

    def _execute_batch_inner(self, key, items) -> None:
        rpc = self.rpc
        out: List[Tuple[_Conn, dict]] = []
        if rpc.deadlines_enabled:
            # dequeue-stage deadline gate: requests whose budget burned
            # away in the shard queue are answered without hydrating,
            # locking, or opening an ack scope for them
            live = []
            for conn, req in items:
                if request_expired(req):
                    out.append((conn, deadline_response(
                        req.get("id"), self._bounded_method(req), "dequeue")))
                else:
                    live.append((conn, req))
            items = live
        doc = (
            rpc._docs.get(key) if isinstance(key, int) and items else None
        )
        if doc is not None and getattr(doc, "_closed", False):
            # cold-demoted document: hydrate once, here, inside this
            # doc's ordered drain — the whole batch then runs against
            # the live instance under ONE ack scope. Failures (e.g. the
            # store's retriable hydration backpressure) fall through to
            # per-request handling, which answers each with the error.
            if all(
                req.get("method") in _NO_HYDRATE_METHODS
                for _c, req in items
            ):
                doc = None  # the cold doc stays cold; no ack scope needed
            else:
                try:
                    doc = rpc._ensure_resident(key)
                except Exception:
                    doc = None
        scope = getattr(doc, "ack_scope", None)
        try:
            with scope() if scope is not None else contextlib.nullcontext():
                i = 0
                while i < len(items):
                    conn, req = items[i]
                    j = self._coalesce_end(items, i)
                    # with the cross-doc batcher active, even a LENGTH-1
                    # receive run takes the coalesced path: its device
                    # feed then joins whatever other documents are
                    # draining right now in one shared kernel launch
                    # (a drain of 100 docs x 1 frame each is the case
                    # the batcher exists for)
                    if j > i or (
                        self._coalesce_key(req) is not None
                        and self._coalesce_single(req)
                    ):
                        self._run_coalesced(items[i : j + 1], out)
                    else:
                        with contextlib.ExitStack() as st:
                            for lk in self._doc_locks(req):
                                st.enter_context(lk)
                            out.append((conn, rpc.handle(req)))
                        if req.get("method") == "free":
                            with self._plain_locks_guard:
                                self._plain_locks.pop(
                                    (req.get("params") or {}).get("doc"), None
                                )
                    i = j + 1
        except Exception as e:  # the deferred group fsync (scope exit) failed
            # an un-fsynced ack is no ack: every result in the batch is
            # converted to an error — the journal poisons itself until a
            # compaction repairs, so nothing later silently builds on this
            obs.count("rpc.errors", labels={"method": "group_commit",
                                            "type": type(e).__name__})
            err = {"type": type(e).__name__,
                   "message": f"group commit failed: {e}"}
            # a poisoned journal / replication-gate timeout is a transient
            # serving condition (failover, reopen, or heal restores it) —
            # tell the client retry loop so. A raw OSError here is the
            # injected-disk-fault first strike: the batch was NOT acked,
            # so a retry is the correct client move there too.
            retriable = getattr(e, "retriable", None)
            if retriable is None and isinstance(e, OSError):
                retriable = True
            err["retriable"] = bool(retriable) if retriable is not None else False
            out = [
                (c, r if "error" in r else {
                    "id": r.get("id"), "error": dict(err)})
                for c, r in out
            ]
        # one write per connection per batch: a drained flight's responses
        # coalesce into a single sendall (16 responses != 16 syscalls)
        with obs.span("serve.write", responses=len(out)):
            grouped: Dict[int, Tuple[_Conn, List[str]]] = {}
            for conn, resp in out:
                grouped.setdefault(id(conn), (conn, []))[1].append(
                    rpc._encode_response(resp)
                )
            for conn, payloads in grouped.values():
                conn.send("\n".join(payloads) + "\n")

    def _coalesce_key(self, req) -> Optional[tuple]:
        """Coalescing key for a request, or None when the method never
        coalesces. ``receiveSyncMessage`` runs on the document (frames
        from DIFFERENT peers still share one device feed);
        ``syncSessionReceive`` runs on the session (the run drains
        through that session's ``receive_many``). The cluster node
        extends this with the follower's ``replApply`` stream."""
        method = req.get("method")
        if method not in _COALESCE_METHODS:
            return None
        params = req.get("params") or {}
        return (
            method,
            params.get("session") if method == "syncSessionReceive"
            else params.get("doc"),
        )

    def _coalesce_single(self, req) -> bool:
        """Whether a LENGTH-1 run of ``req``'s method still routes
        through the coalesced path (so its device feed joins the
        cross-doc batcher): the batcher decides by the mirror the
        request would feed."""
        return self.batcher.active(self._mirror_of(req))

    def _mirror_of(self, req):
        """The resident mirror a receive request's feed goes to (the
        session's, or the document's), or None. Never hydrates."""
        params = req.get("params") or {}
        if req.get("method") == "syncSessionReceive":
            sess = self.rpc._sessions.get(params.get("session"))
            return getattr(sess, "device_doc", None)
        return getattr(self.rpc._docs.get(params.get("doc")), "device_doc", None)

    @staticmethod
    def _run_error(out, first: int, method: str, e: Exception) -> None:
        """Answer every request of a coalesced run appended to ``out``
        from ``first`` on that has not already failed with ``e``, each
        counted in ``rpc.errors``: the failure reaches each client."""
        err = {"type": type(e).__name__, "message": str(e),
               "retriable": bool(getattr(e, "retriable", False))}
        n = sum("error" not in r for _c, r in out[first:])
        obs.count("rpc.errors", n=n, labels={"method": method,
                                             "type": type(e).__name__})
        out[first:] = [
            (c, r if "error" in r else {"id": r.get("id"), "error": dict(err)})
            for c, r in out[first:]
        ]

    def _coalesce_end(self, items, i) -> int:
        """Last index of the run starting at ``i`` of coalescable
        frames (length-1 runs return ``i``)."""
        key = self._coalesce_key(items[i][1])
        if key is None:
            return i
        j = i
        while j + 1 < len(items) and self._coalesce_key(items[j + 1][1]) == key:
            j += 1
        return j

    def _run_coalesced(self, run, out) -> None:
        """A run of receive frames for one doc/session: the host applies
        stay per-message (protocol state machines need each), but the
        resident-device feed drains into one ``apply_batches`` call."""
        method = run[0][1].get("method")
        if len(run) > 1:  # length-1 runs only ride the cross-doc batcher
            obs.count("rpc.coalesced", n=len(run), labels={"method": method})
        with contextlib.ExitStack() as st:
            for lk in self._doc_locks(run[0][1]):
                st.enter_context(lk)
            if method == "syncSessionReceive":
                self._run_session_receive(run, out)
            else:
                self._run_receive_sync(run, out)

    def _run_session_receive(self, run, out) -> None:
        rpc = self.rpc
        import base64

        frames, live = [], []
        for conn, req in run:
            p = req.get("params") or {}
            # the coalesced path bypasses rpc.handle: enforce the final
            # deadline stage per frame here
            if rpc.deadlines_enabled and request_expired(req):
                out.append((conn, deadline_response(
                    req.get("id"), "syncSessionReceive", "pre_fsync")))
                continue
            try:
                sess = rpc._session(p)
                frames.append(base64.b64decode(p["data"]))
                live.append((conn, req, sess))
            except Exception as e:
                obs.count("rpc.errors", labels={
                    "method": "syncSessionReceive", "type": type(e).__name__})
                out.append((conn, {"id": req.get("id"), "error": {
                    "type": type(e).__name__, "message": str(e),
                    "retriable": bool(getattr(e, "retriable", False))}}))
        if not live:
            return
        sess = live[0][2]
        dev = sess.device_doc
        feed = (
            (lambda batches: self._feed_device(dev, batches))
            if dev is not None
            else None
        )
        try:
            with obs.span("rpc.request", links=_run_trace_links(run),
                          labels={"method": "syncSessionReceive"}):
                accepted = sess.receive_many(
                    frames, time.monotonic(), device_feed=feed
                )
        except Exception as e:
            # the session counted a failed feed (sync.device_feed_error);
            # its host document holds every frame's changes, its mirror
            # does not: each request of the run answers with the error
            first = len(out)
            out.extend((conn, {"id": req.get("id")}) for conn, req, _ in live)
            self._run_error(out, first, "syncSessionReceive", e)
            return
        for (conn, req, _), ok in zip(live, accepted):
            out.append((conn, {"id": req.get("id"),
                               "result": {"accepted": ok}}))

    def _run_receive_sync(self, run, out) -> None:
        rpc = self.rpc
        import base64

        from ..sync.protocol import Message

        doc = None
        changes_batches = []
        first = len(out)
        with obs.span("rpc.request", links=_run_trace_links(run),
                      labels={"method": "receiveSyncMessage"}):
            for conn, req in run:
                p = req.get("params") or {}
                if rpc.deadlines_enabled and request_expired(req):
                    out.append((conn, deadline_response(
                        req.get("id"), "receiveSyncMessage", "pre_fsync")))
                    continue
                try:
                    doc = rpc._doc(p)
                    msg = Message.decode(base64.b64decode(p["data"]))
                    doc.receive_sync_message(rpc._syncs[p["sync"]], msg)
                    if msg.changes:
                        changes_batches.append(list(msg.changes))
                    out.append((conn, {"id": req.get("id"), "result": None}))
                except Exception as e:
                    obs.count("rpc.errors", labels={
                        "method": "receiveSyncMessage",
                        "type": type(e).__name__})
                    out.append((conn, {"id": req.get("id"), "error": {
                        "type": type(e).__name__, "message": str(e),
                        "retriable": bool(getattr(e, "retriable", False))}}))
        dev = getattr(doc, "device_doc", None)
        if dev is not None and changes_batches:
            try:
                self._feed_device(dev, changes_batches)
            except Exception as e:
                # counted as the JAX package counts it, then answered: the
                # run's acks become the error (the host document holds
                # the changes, the mirror does not)
                obs.count("sync.device_feed_error", error=str(e)[:200])
                self._run_error(out, first, "receiveSyncMessage", e)

    def _feed_device(self, dev, batches) -> None:
        """Route a drained document's device feed through the cross-doc
        batcher (one shared kernel launch with whatever other documents
        are draining right now) or, when batching is off for this
        backend, through the per-doc pipelined path."""
        if self.batcher.active(dev):
            self.batcher.apply(dev, batches)
        else:
            dev.apply_batches(batches)
