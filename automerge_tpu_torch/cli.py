"""Command-line interface: export / import / merge / examine / examine-sync
/ change / journal-info / compact / metrics / serve / cluster-router /
cluster-metrics / cluster-history / cluster-top / flight-merge /
perf-report.

Mirrors the reference CLI's subcommands (reference:
rust/automerge-cli/src/main.rs:81-161). Documents read and write the
binary automerge format; export/import speak JSON.

    python -m automerge_tpu_torch export doc.automerge
    python -m automerge_tpu_torch import state.json -o doc.automerge
    python -m automerge_tpu_torch merge a.automerge b.automerge -o merged.automerge
    python -m automerge_tpu_torch examine doc.automerge
    python -m automerge_tpu_torch examine-sync msg.sync
    python -m automerge_tpu_torch change doc.automerge 'set .title "hi"' -o out.automerge
    python -m automerge_tpu_torch --device cpu export doc.automerge

The port of ``automerge_tpu/cli.py``: the same subcommands, options,
outputs, files, exit codes and stderr text. Its differences, each on
purpose:

* **``--device DEVICE``**, before the subcommand, which the reference
  lacks. Every document a command builds (``export``, ``import``,
  ``merge``, ``examine``, ``change``, ``compact``, ``metrics``) lives on
  it, so a load or merge runs its bulk catch-up through the merge
  kernels there. Left out it means the card: without a GPU such a
  command prints the port's no-GPU message to stderr and exits 1;
  nothing falls back to the CPU. ``--device cpu`` is the plain PyTorch
  path.
* ``serve`` passes ``--device`` on to ``rpc.main`` (the reference's
  ``cmd_serve`` forwards no device); left out, the server takes the card
  under the same rule.
* ``examine-sync``, ``journal-info``, ``flight-merge``, ``perf-report``,
  ``cluster-router`` and the commands that only scrape over the network
  (``cluster-metrics``, ``cluster-history``, ``cluster-top``, ``perf-report
  --connect``) hold no document and take no device.
* Text that names the package names this one (``usage:
  automerge_tpu_torch``, ``serve``'s pointer to
  ``automerge_tpu_torch.rpc``).
"""

from __future__ import annotations

import argparse
import json
import shlex
import sys
from typing import List, Optional

from .api import AutoDoc
from .device import resolve_device
from .expanded import expand_change
from .types import ObjType, ScalarValue


def _read(path: Optional[str]) -> bytes:
    if path is None or path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: Optional[str], data: bytes) -> None:
    if path is None or path == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def _load_doc(args) -> AutoDoc:
    doc = AutoDoc.load(
        _read(args.input),
        verify=not args.skip_verifying_heads,
        on_error="salvage" if getattr(args, "salvage", False) else None,
        device=args.device,
    )
    rep = doc.salvage_report
    if rep is not None and rep.dropped:
        print(f"salvage: {rep.summary()}", file=sys.stderr)
        for d in rep.dropped:
            print(
                f"salvage: dropped span at {d.offset}: {d.reason}"
                + (f" (checksum {d.checksum.hex()})" if d.checksum else ""),
                file=sys.stderr,
            )
    return doc


def _watch_loop(seconds: float, emit) -> int:
    """``--watch`` loop: clear the terminal, render once, sleep,
    repeat. Ctrl-C is the intended exit and returns 0 (a clean status),
    not a traceback."""
    import time

    try:
        while True:
            sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.flush()
            rc = emit()
            if rc != 0:
                return rc
            time.sleep(max(0.1, seconds))
    except KeyboardInterrupt:
        sys.stdout.write("\n")
        return 0


def _rpc_once(addr: str, method: str, params, tag: str):
    """One-shot JSON-RPC request over a short-lived TCP connection (the
    perf-report idiom). Returns ``(result, None)`` on success or
    ``(None, exit_code)`` with the error already printed to stderr."""
    import socket

    host, _, port = addr.rpartition(":")
    req = {"id": 1, "method": method}
    if params:
        req["params"] = params
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=10) as sock:
            sock.settimeout(30)
            sock.sendall((json.dumps(req) + "\n").encode())
            raw = sock.makefile("r").readline()
    except (OSError, ValueError) as e:
        print(f"{tag}: {addr}: {e}", file=sys.stderr)
        return None, 1
    if not raw:
        print(f"{tag}: server closed the connection", file=sys.stderr)
        return None, 1
    resp = json.loads(raw)
    if "error" in resp:
        print(f"{tag}: {resp['error']}", file=sys.stderr)
        return None, 1
    return resp["result"], None


def cmd_export(args) -> int:
    doc = _load_doc(args)
    out = json.dumps(doc.hydrate(), indent=2, ensure_ascii=False)
    _write(args.out, (out + "\n").encode())
    return 0


def _import_value(doc, obj, key, value, insert=False):
    from .functional import write_value

    write_value(doc, obj, key, value, insert=insert, str_as_text=True, sort_keys=True)


def cmd_import(args) -> int:
    data = json.loads(_read(args.input).decode())
    if not isinstance(data, dict):
        print("import: top-level JSON value must be an object", file=sys.stderr)
        return 1
    doc = AutoDoc(device=args.device)
    for k in sorted(data):
        _import_value(doc, "_root", k, data[k])
    doc.commit()
    _write(args.out, doc.save())
    return 0


def cmd_merge(args) -> int:
    if not args.input:
        print("merge: provide at least one input file", file=sys.stderr)
        return 1
    doc = AutoDoc.load(_read(args.input[0]), device=args.device)
    for path in args.input[1:]:
        doc.merge(AutoDoc.load(_read(path), device=args.device))
    _write(args.out, doc.save())
    return 0


def cmd_examine(args) -> int:
    doc = _load_doc(args)
    changes = [expand_change(a.stored) for a in doc.doc.history]
    _write(args.out, (json.dumps(changes, indent=2) + "\n").encode())
    return 0


def cmd_examine_sync(args) -> int:
    from .sync import Message
    from .sync.session import SESSION_FRAME_TYPE, decode_frame

    data = _read(args.input)
    frame = None
    if data[:1] == bytes([SESSION_FRAME_TYPE]):
        epoch, flags, seq, inner = decode_frame(data)
        frame = {"epoch": epoch, "flags": flags, "seq": seq}
        data = inner
    if frame is not None and not data:
        _write(args.out, (json.dumps({"frame": frame}, indent=2) + "\n").encode())
        return 0
    msg = Message.decode(data)
    out = {
        "heads": [h.hex() for h in msg.heads],
        "need": [h.hex() for h in msg.need],
        "have": [
            {
                "lastSync": [h.hex() for h in h_.last_sync],
                "bloom": h_.bloom.to_bytes().hex(),
            }
            for h_ in msg.have
        ],
        "changes": [expand_change(c) for c in msg.changes],
    }
    if frame is not None:
        out = {"frame": frame, "message": out}
    _write(args.out, (json.dumps(out, indent=2) + "\n").encode())
    return 0


def _resolve_path(doc, path: str):
    """'.a.b[2].c' -> (object id, final key). Root path '.' is ('_root', None)."""
    obj = "_root"
    parts: List = []
    for seg in path.strip().lstrip(".").split("."):
        if not seg:
            continue
        while "[" in seg:
            name, rest = seg.split("[", 1)
            idx, seg = rest.split("]", 1)
            if name:
                parts.append(name)
            parts.append(int(idx))
        if seg:
            parts.append(seg)
    if not parts:
        return obj, None
    for p in parts[:-1]:
        val = doc.get(obj, p)
        if val is None or val[0][0] != "obj":
            raise ValueError(f"path segment {p!r} is not an object")
        obj = val[0][2]
    return obj, parts[-1]


def _script_value(tok: str):
    try:
        return json.loads(tok)
    except json.JSONDecodeError:
        return tok


def cmd_change(args) -> int:
    """Apply an edit script: set/insert/delete/increment/splice commands
    (reference: automerge-cli/src/change.rs script language)."""
    doc = (
        AutoDoc.load(_read(args.input), device=args.device)
        if args.input
        else AutoDoc(device=args.device)
    )
    script = args.script
    if script == "-":
        script_lines = sys.stdin.read().splitlines()
    else:
        script_lines = script.split(";")
    for line in script_lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        toks = shlex.split(line)
        cmd, path = toks[0].lower(), toks[1]
        obj, key = _resolve_path(doc, path)
        if cmd == "set":
            value = _script_value(toks[2])
            if isinstance(value, (dict, list, str)) and not isinstance(value, bool):
                _import_value(doc, obj, key, value)
            else:
                doc.put(obj, key, value)
        elif cmd == "insert":
            value = _script_value(toks[2])
            if isinstance(value, (dict, list, str)) and not isinstance(value, bool):
                _import_value(doc, obj, key, value, insert=True)
            else:
                doc.insert(obj, key, value)
        elif cmd in ("delete", "del"):
            doc.delete(obj, key)
        elif cmd in ("increment", "inc"):
            doc.increment(obj, key, int(toks[2]) if len(toks) > 2 else 1)
        elif cmd == "splice":
            val = doc.get(obj, key)
            if val is None or val[0][0] != "obj":
                raise ValueError(f"splice target {path!r} is not a text object")
            doc.splice_text(val[0][2], int(toks[2]), int(toks[3]), toks[4] if len(toks) > 4 else "")
        elif cmd == "counter":
            doc.put(obj, key, ScalarValue("counter", int(toks[2])))
        else:
            print(f"change: unknown command {cmd!r}", file=sys.stderr)
            return 1
    doc.commit()
    _write(args.out, doc.save())
    return 0


def cmd_journal_info(args) -> int:
    """Report a durable document directory's journal state — read-only
    (a torn tail is reported but NOT truncated; ``open``/``compact`` do
    the repairing)."""
    import os

    from .storage.durable import JOURNAL_NAME, SNAPSHOT_NAME
    from .storage.journal import (
        REC_CHANGE,
        REC_META,
        salvage_header_scan,
        scan_records,
    )

    jpath = os.path.join(args.input, JOURNAL_NAME)
    spath = os.path.join(args.input, SNAPSHOT_NAME)
    if not os.path.exists(jpath):
        print(f"journal-info: no journal at {jpath}", file=sys.stderr)
        return 1
    with open(jpath, "rb") as f:
        data = f.read()
    records, tail = scan_records(data)
    if tail.reason == "bad journal magic":
        # report what open()'s header salvage will actually recover (the
        # SAME helper it uses), not a misleading total loss
        records = salvage_header_scan(data)
        kept = sum(r.end - r.offset for r in records)
        tail = tail._replace(
            # the file as stored is unusable until open() rewrites it; the
            # records count + reason carry the actual recovery story
            valid_bytes=0,
            records=len(records),
            reason=(
                "bad journal magic (header will be rewritten on open; "
                f"{len(records)} records / {kept} bytes recoverable)"
            ),
        )
    info = {
        "records": len(records),
        "change_records": sum(1 for r in records if r.rec_type == REC_CHANGE),
        "meta_records": sum(1 for r in records if r.rec_type == REC_META),
        "bytes": tail.total_bytes,
        "valid_bytes": tail.valid_bytes,
        # any nonempty reason is reported, even when every record remains
        # recoverable (e.g. a damaged header open() will rewrite)
        "torn_tail": (
            {"reason": tail.reason, "dropped_bytes": tail.dropped_bytes}
            if (tail.torn or tail.reason)
            else None
        ),
        "snapshot_bytes": (
            os.path.getsize(spath) if os.path.exists(spath) else None
        ),
    }
    if os.path.exists(spath):
        from .storage.runsnap import MAGIC as _ARSN_MAGIC

        with open(spath, "rb") as f:
            head = f.read(len(_ARSN_MAGIC))
        info["snapshot_codec"] = (
            "runsnap" if head == _ARSN_MAGIC else "chunk"
        )
    rc = 0
    if getattr(args, "verify", False):
        # deep read-back scan (the scrubber's own core): every journal
        # record CRC-checked and every snapshot chunk walked strictly —
        # the first bad byte offset names where the rot starts
        from .integrity import verify_doc_dir

        reports = verify_doc_dir(args.input)
        info["verify"] = [
            {
                "kind": r.kind,
                "ok": r.ok,
                "bytes": r.total_bytes,
                "valid_bytes": r.valid_bytes,
                "units": r.units,
                "first_bad_offset": r.first_bad_offset,
                **({"reason": r.reason} if r.reason else {}),
            }
            for r in reports
        ]
        bad = [r for r in reports if not r.ok]
        if bad:
            rc = 1
            for r in bad:
                print(
                    f"journal-info: {r.kind} corrupt at byte "
                    f"{r.first_bad_offset} ({r.reason or 'checksum'})",
                    file=sys.stderr,
                )
    _write(args.out, (json.dumps(info, indent=2) + "\n").encode())
    return rc


def cmd_compact(args) -> int:
    """Force a snapshot + journal truncation on a durable document
    directory (recovering any torn tail on the way in)."""
    import os

    from .api import AutoDoc
    from .storage.durable import JOURNAL_NAME

    # opening a mistyped path would CREATE a fresh durable doc there;
    # compacting only ever makes sense on one that already exists
    if not os.path.exists(os.path.join(args.input, JOURNAL_NAME)):
        print(f"compact: no durable document at {args.input}", file=sys.stderr)
        return 1
    from .storage.journal import JournalError

    try:
        dd = AutoDoc.open(args.input, fsync="never", device=args.device)
    except JournalError as e:
        print(f"compact: {e}", file=sys.stderr)
        return 1
    try:
        before = dd.journal.record_count
        if not dd.compact():
            print("compact: skipped (journal busy)", file=sys.stderr)
            return 1
        out = {
            "compacted": True,
            "records_before": before,
            "records_after": dd.journal.record_count,
            "journal_bytes": dd.journal.size_bytes,
        }
    finally:
        dd.close()
    _write(args.out, (json.dumps(out, indent=2) + "\n").encode())
    return 0


def cmd_metrics(args) -> int:
    """Exercise the instrumented load path on a document (a save file or
    a durable directory), then dump the metrics registry — Prometheus
    text by default, ``--format json`` for the structured snapshot,
    ``--trace-out trace.json`` for a Perfetto/Chrome-trace span dump of
    everything the load did."""
    import os

    from . import obs

    if args.input:
        if os.path.isdir(args.input):
            from .storage.journal import JournalError

            try:
                dd = AutoDoc.open(args.input, fsync="never",
                                  device=args.device)
            except JournalError as e:
                print(f"metrics: {e}", file=sys.stderr)
                return 1
            try:
                n = len(dd.doc.history)
            finally:
                dd.close()
            print(f"metrics: replayed durable doc ({n} changes)",
                  file=sys.stderr)
        else:
            doc = AutoDoc.load(_read(args.input), on_error="salvage",
                               device=args.device)
            rep = doc.salvage_report
            if rep is not None and rep.dropped:
                print(f"metrics: {rep.summary()}", file=sys.stderr)
    def emit() -> int:
        if args.format == "json":
            body = json.dumps(
                {
                    "metrics": obs.snapshot(),
                    "counters": dict(obs.legacy_counters),
                    "timings": obs.timing_summary(),
                },
                indent=2,
            ) + "\n"
        else:
            body = obs.render_prometheus()
        _write(args.out, body.encode())
        return 0

    if args.watch:
        return _watch_loop(args.watch, emit)
    emit()
    if args.trace_out:
        n_spans = obs.export_trace(args.trace_out)
        print(
            f"metrics: wrote {n_spans} spans to {args.trace_out} "
            "(open at https://ui.perfetto.dev)",
            file=sys.stderr,
        )
    return 0


def cmd_cluster_metrics(args) -> int:
    """Scrape a cluster router's ``clusterMetrics`` method: every node's
    Prometheus exposition merged into one family set, each sample
    labeled ``node="<addr>"`` (the router itself is ``node="router"``).
    Unreachable nodes are reported on stderr, never fatal."""

    def emit() -> int:
        result, rc = _rpc_once(args.router, "clusterMetrics", None,
                               "cluster-metrics")
        if result is None:
            return rc
        for bad in result.get("unreachable", ()):
            print(f"cluster-metrics: unreachable {bad['node']}: "
                  f"{bad['error']}", file=sys.stderr)
        if args.format == "json":
            _write(args.out, (json.dumps(result, indent=2) + "\n").encode())
        else:
            _write(args.out, result["body"].encode())
        return 0

    if args.watch:
        return _watch_loop(args.watch, emit)
    return emit()


def cmd_cluster_history(args) -> int:
    """Query a node's in-memory history rings (obs/history.py): the
    1s/10s/60s downsampled recent past of the allowlisted metrics,
    fetched over the ``historyStatus`` RPC. Works against any server or
    cluster node address (followers answer too)."""
    params = {}
    if args.metric:
        params["name"] = args.metric
    if args.tier is not None:
        params["tier"] = args.tier

    def emit() -> int:
        result, rc = _rpc_once(args.connect, "historyStatus", params,
                               "cluster-history")
        if result is None:
            return rc
        if args.format == "json":
            _write(args.out, (json.dumps(result, indent=2) + "\n").encode())
            return 0
        lines = [
            f"history: tiers {result.get('tiers')}  "
            f"samples {result.get('samples', 0)}  "
            f"series cap {result.get('cap')}  "
            f"dropped {result.get('droppedSeries', 0)}"
        ]
        for s in result.get("series") or ():
            lines.append(f"{s.get('name')} ({s.get('type')})")
            tiers = s.get("tiers") or {}
            for t in sorted(tiers, key=int):
                slots = tiers[t][-args.last:]
                if not slots:
                    continue
                if s.get("type") == "counter":
                    body = "  ".join(
                        f"{sl.get('delta', 0.0):g}" for sl in slots)
                else:
                    body = "  ".join(
                        f"{sl.get('max', 0.0):g}" for sl in slots)
                lines.append(f"  tier {t}: {body}")
        _write(args.out, ("\n".join(lines) + "\n").encode())
        return 0

    if args.watch:
        return _watch_loop(args.watch, emit)
    return emit()


def cmd_cluster_top(args) -> int:
    """Live cluster heat view: the router's ``clusterAdvise`` RPC —
    per-group load from the doc-heat tables, follower staleness, and
    the placement advisor's ranked, explained, report-only
    recommendations. ``--watch N`` turns it into a top(1)-style
    redraw loop."""
    from .cluster import advisor

    params = {}
    if args.snapshot:
        params["snapshot"] = True

    def emit() -> int:
        result, rc = _rpc_once(args.router, "clusterAdvise", params,
                               "cluster-top")
        if result is None:
            return rc
        if args.format == "json":
            _write(args.out, (json.dumps(result, indent=2) + "\n").encode())
        else:
            _write(args.out,
                   advisor.render_text(result, top=args.top).encode())
        return 0

    if args.watch:
        return _watch_loop(args.watch, emit)
    return emit()


def cmd_flight_merge(args) -> int:
    """Stitch flight-recorder dumps (``flight-*.json``, written by
    server processes on exit/failover) into one Perfetto/Chrome-trace
    timeline: one pid per process, clocks aligned from RTT-midpoint
    samples where available (wall clock otherwise), span parent/link ids
    connecting one request's spans across every process it touched."""
    import glob
    import os

    from .obs.flight import merge_flights

    paths = []
    for inp in args.input:
        if os.path.isdir(inp):
            paths.extend(sorted(glob.glob(os.path.join(inp, "flight-*.json"))))
        else:
            paths.append(inp)
    if not paths:
        print("flight-merge: no flight dumps found", file=sys.stderr)
        return 1
    try:
        doc, info = merge_flights(paths)
    except (OSError, ValueError, KeyError) as e:
        print(f"flight-merge: {e}", file=sys.stderr)
        return 1
    _write(args.out, json.dumps(doc).encode())
    print(
        f"flight-merge: {info['spans']} spans from "
        f"{len(info['processes'])} processes "
        "(open at https://ui.perfetto.dev)",
        file=sys.stderr,
    )
    for name, p in sorted(info["processes"].items()):
        print(f"flight-merge:   pid {p['pid']}: {name} "
              f"({p['spans']} spans, clock: {p['aligned']})",
              file=sys.stderr)
    return 0


def cmd_perf_report(args) -> int:
    """Render the drain-cycle performance observatory (obs/prof.py):
    live from a running server's ``perfStatus`` RPC (``--connect``), or
    offline from flight-recorder dumps — every finished drain cycle
    lands in the flight ring as a ``drain.cycle_report`` event, so a
    dead process's last dump still answers "where did the drain wall
    clock go". The text report includes the h2d byte line (actual
    staged bytes vs dense equivalent and the compress ratio — the
    compressed-residency win per drain)."""
    import glob
    import os
    import socket

    from .obs import prof

    if args.connect:
        host, _, port = args.connect.rpartition(":")
        req = {"id": 1, "method": "perfStatus",
               "params": {"top": args.top}}
        try:
            with socket.create_connection((host or "127.0.0.1", int(port)),
                                          timeout=10) as sock:
                sock.settimeout(30)
                sock.sendall((json.dumps(req) + "\n").encode())
                raw = sock.makefile("r").readline()
        except (OSError, ValueError) as e:
            print(f"perf-report: {args.connect}: {e}", file=sys.stderr)
            return 1
        if not raw:
            print("perf-report: server closed the connection",
                  file=sys.stderr)
            return 1
        resp = json.loads(raw)
        if "error" in resp:
            print(f"perf-report: {resp['error']}", file=sys.stderr)
            return 1
        summary = resp["result"]
    else:
        paths = []
        for inp in args.input:
            if os.path.isdir(inp):
                paths.extend(
                    sorted(glob.glob(os.path.join(inp, "flight-*.json"))))
            else:
                paths.append(inp)
        if not paths:
            print("perf-report: provide --connect HOST:PORT or flight "
                  "dumps / directories", file=sys.stderr)
            return 1
        events = []
        for p in paths:
            with open(p) as f:
                d = json.load(f)
            if d.get("format") != "automerge_tpu-flight-v1":
                print(f"perf-report: {p}: not a flight dump",
                      file=sys.stderr)
                return 1
            events.extend(d.get("events", ()))
        summary = prof.summarize_flight_events(events)
        if not summary["cycles"]:
            print("perf-report: no drain.cycle_report events in the "
                  "given dumps (profiling off, or no drains ran)",
                  file=sys.stderr)
            return 1
    if args.format == "json":
        _write(args.out, (json.dumps(summary, indent=2) + "\n").encode())
    else:
        _write(args.out, prof.render_text(summary, top=args.top).encode())
    return 0


def cmd_serve(args) -> int:
    """Run the concurrent JSON-RPC server (serve/server.py) over TCP or
    a unix-domain socket — the same method surface as the stdio frontend
    (``python -m automerge_tpu_torch.rpc``) with per-document parallelism,
    group-commit durability and backpressure. Delegates to rpc.main so
    both entry points stay behaviourally identical."""
    from .rpc import main as rpc_main

    argv = []
    if args.socket:
        argv += ["--socket", args.socket]
    if args.unix:
        argv += ["--unix", args.unix]
    if args.durable:
        argv += ["--durable", args.durable]
    if args.workers is not None:
        argv += ["--workers", str(args.workers)]
    if args.device is not None:
        argv += ["--device", args.device]
    if not args.socket and not args.unix:
        print("serve: provide --socket HOST:PORT or --unix PATH "
              "(plain stdio mode is `python -m automerge_tpu_torch.rpc`)",
              file=sys.stderr)
        return 1
    return rpc_main(argv)


def cmd_cluster_router(args) -> int:
    """Run the cluster router tier (cluster/router.py): consistent-hash
    document placement over backend shard groups, heartbeat-driven
    leader failover with promotion from the longest durable acked
    prefix, and live shard migration. Delegates to the router's own
    main so the module entry point stays behaviourally identical."""
    from .cluster.router import main as router_main

    argv = ["--listen", args.listen]
    for g in args.group:
        argv += ["--group", g]
    if args.heartbeat is not None:
        argv += ["--heartbeat", str(args.heartbeat)]
    if args.miss_limit is not None:
        argv += ["--miss-limit", str(args.miss_limit)]
    return router_main(argv)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="automerge_tpu_torch", description=__doc__)
    p.add_argument("--device", default=None, metavar="DEVICE",
                   help="torch device the command's documents live on "
                        "(default: the card; 'cpu' runs the plain PyTorch "
                        "path)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.set_defaults(fn=fn)
        sp.add_argument("-o", "--out", default=None, help="output file (default stdout)")
        return sp

    sp = add("export", cmd_export, help="document -> JSON")
    sp.add_argument("input", nargs="?", help="input .automerge file (default stdin)")
    sp.add_argument("--skip-verifying-heads", action="store_true")
    sp.add_argument("--salvage", action="store_true",
                    help="recover what a damaged save still holds "
                         "(dropped spans are reported on stderr)")

    sp = add("import", cmd_import, help="JSON -> document")
    sp.add_argument("input", nargs="?", help="input JSON file (default stdin)")

    sp = add("merge", cmd_merge, help="merge N documents into one")
    sp.add_argument("input", nargs="*", help="input .automerge files")

    sp = add("examine", cmd_examine, help="dump a document's changes as JSON")
    sp.add_argument("input", nargs="?", help="input .automerge file (default stdin)")
    sp.add_argument("--skip-verifying-heads", action="store_true")
    sp.add_argument("--salvage", action="store_true",
                    help="recover what a damaged save still holds "
                         "(dropped spans are reported on stderr)")

    sp = add("examine-sync", cmd_examine_sync, help="decode a sync message")
    sp.add_argument("input", nargs="?", help="input sync message file (default stdin)")

    sp = add("journal-info", cmd_journal_info,
             help="inspect a durable document directory's journal (read-only)")
    sp.add_argument("input", help="durable document directory")
    sp.add_argument("--verify", action="store_true",
                    help="deep read-back scan: CRC-check every journal "
                         "record and walk every snapshot chunk; exits 1 "
                         "and reports the first bad offset on corruption")

    sp = add("compact", cmd_compact,
             help="snapshot a durable document and truncate its journal")
    sp.add_argument("input", help="durable document directory")

    sp = add("metrics", cmd_metrics,
             help="load a document (file or durable dir) and dump the "
                  "metrics registry (Prometheus text or JSON)")
    sp.add_argument("input", nargs="?",
                    help="optional .automerge file or durable document "
                         "directory to load first (instruments the load)")
    sp.add_argument("--format", choices=("prometheus", "json"),
                    default="prometheus")
    sp.add_argument("--trace-out", default=None, metavar="PATH",
                    help="also export recorded spans as Perfetto/"
                         "Chrome-trace JSON to PATH")
    sp.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="redraw the dump every SECONDS until Ctrl-C")

    sp = sub.add_parser(
        "serve",
        help="run the concurrent JSON-RPC server over TCP or unix socket",
    )
    sp.set_defaults(fn=cmd_serve)
    sp.add_argument("--socket", metavar="HOST:PORT", default=None,
                    help="TCP listen address (port 0 picks a free port)")
    sp.add_argument("--unix", metavar="PATH", default=None,
                    help="unix-domain socket path")
    sp.add_argument("--durable", metavar="DIR", default=None,
                    help="enable openDurable persistence under DIR")
    sp.add_argument("--workers", type=int, default=None,
                    help="worker pool size (default "
                         "AUTOMERGE_TPU_SERVE_WORKERS or 8)")

    sp = add("cluster-metrics", cmd_cluster_metrics,
             help="scrape a cluster router: every node's metrics merged "
                  "into one family set with node labels")
    sp.add_argument("router", metavar="HOST:PORT",
                    help="router address to scrape")
    sp.add_argument("--format", choices=("prometheus", "json"),
                    default="prometheus")
    sp.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="re-scrape and redraw every SECONDS until Ctrl-C")

    sp = add("cluster-history", cmd_cluster_history,
             help="query a node's history rings: downsampled recent "
                  "past of the allowlisted metrics")
    sp.add_argument("connect", metavar="HOST:PORT",
                    help="server or cluster node address")
    sp.add_argument("--metric", default=None,
                    help="restrict to one metric family name")
    sp.add_argument("--tier", type=int, default=None,
                    help="restrict to one tier index (0=1s, 1=10s, 2=60s)")
    sp.add_argument("--last", type=int, default=20,
                    help="slots shown per tier in text mode")
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="redraw every SECONDS until Ctrl-C")

    sp = add("cluster-top", cmd_cluster_top,
             help="live cluster heat view: group loads, staleness, and "
                  "the placement advisor's report-only recommendations")
    sp.add_argument("router", metavar="HOST:PORT",
                    help="cluster router address")
    sp.add_argument("--top", type=int, default=None,
                    help="recommendations shown in text mode")
    sp.add_argument("--snapshot", action="store_true",
                    help="include the raw telemetry snapshot (json mode)")
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="redraw every SECONDS until Ctrl-C")

    sp = add("perf-report", cmd_perf_report,
             help="drain-cycle stage attribution: host/device split, "
                  "occupancy, top docs — live (--connect) or from "
                  "flight dumps")
    sp.add_argument("input", nargs="*",
                    help="flight-*.json dumps (or directories holding "
                         "them) for offline mode")
    sp.add_argument("--connect", metavar="HOST:PORT", default=None,
                    help="scrape a live server's perfStatus RPC instead")
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.add_argument("--top", type=int, default=8,
                    help="rows in the expensive-docs table")

    sp = add("flight-merge", cmd_flight_merge,
             help="merge flight-recorder dumps from several processes "
                  "into one clock-aligned Perfetto timeline")
    sp.add_argument("input", nargs="+",
                    help="flight-*.json dump files (or directories "
                         "holding them)")

    sp = sub.add_parser(
        "cluster-router",
        help="run the cluster router: consistent-hash placement, "
             "leader failover, live shard migration",
    )
    sp.set_defaults(fn=cmd_cluster_router)
    sp.add_argument("--listen", metavar="HOST:PORT", default="127.0.0.1:0",
                    help="client-facing listen address")
    sp.add_argument("--group", action="append", required=True,
                    metavar="ADDR,ADDR,...",
                    help="one shard group: comma-separated node "
                         "addresses, leader first (repeatable)")
    sp.add_argument("--heartbeat", type=float, default=None,
                    help="leader liveness poll interval, seconds")
    sp.add_argument("--miss-limit", type=int, default=None,
                    help="consecutive missed heartbeats before failover")

    sp = add("change", cmd_change, help="apply an edit script to a document")
    sp.add_argument("input", nargs="?", help="input .automerge file (omit to start empty)")
    sp.add_argument(
        "script",
        help="';'-separated commands: set PATH VALUE | insert PATH VALUE | "
        "delete PATH | increment PATH [N] | splice PATH POS DEL TEXT | "
        "counter PATH N  ('-' reads commands from stdin, one per line)",
    )
    return p


# the commands that build a document: they resolve --device up front
_DOCUMENT_COMMANDS = frozenset(
    {cmd_export, cmd_import, cmd_merge, cmd_examine, cmd_change,
     cmd_compact, cmd_metrics}
)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fn in _DOCUMENT_COMMANDS:
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"automerge_tpu_torch: {e}", file=sys.stderr)
            return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
