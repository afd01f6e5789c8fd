"""Chip smoke test of automerge_tpu_torch on one NVIDIA GPU: the fan-in
merge of a text document, the fan-in of a record store, the record store
served batch by batch, 128 documents' drained deltas resolved in
packed launches (``ops/batched.py``), documents opened cold from ARSN
run images (``storage/runsnap.py``), the document layer catching up on
both fan-ins (``api.AutoDoc``, ``core/document.py``: the stale read, the
op-store rebuild, save and load) and over sync sessions (``sync/``: a
replica fed over lossy channels, and 128 served documents fed by their
sessions through the cross-document batcher), durable storage
(``storage/durable.py``: a journaled document with a resident mirror,
reopened cold, moved through the tiered store, and followed through a
replicated apply), the serving layer (``rpc.py``, ``serve/``: a socket
server whose mirrored documents are fed by sync-session peers over TCP
through the cross-document batcher, and a fresh server process), the
cluster tier (``cluster/``: a leader replicating to a mirrored follower
whose drains feed its mirrors in packed launches, a second group, a
router, a failover and two migrations), the native edit sessions, the
command line and the dot dump (``cli.py``, ``native/session.cpp``,
``visualisation.py``: typing and puts through the sessions, their
rebuilds through the merge kernels, a merge of eight files), the C ABI
(``capi/``: the reference's five C suites on the card, ``am_load`` and
typing through the library's hot-call cache), end to end
through hand-written
CUDA kernels, with the columns staged as run tables (run-native, the default), the
packed transport, the chain-condensed document order, the sharded merge
over meshes of four and sixteen shards on the card, and historical views
of the documents (``DeviceDoc.at``: the whole log resolved under a clock
mask with false rows), their reads, ``diff`` and ``make_patches``.

    python3 chip_smoke.py            # full width, as below
    python3 chip_smoke.py --cards    # on four cards: phases 1, 2 and (g) only
    python3 chip_smoke.py --obs-cost TREE WORKLOAD   # one process of (q)

Phases, each raising on failure (nothing is caught):

 1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
    no CUDA device is an error;
 2. build the kernels from automerge_tpu_torch/csrc with nvcc (sm_90a)
    and the native host library from automerge_tpu_torch/native with g++
    (its seconds printed);
 3. the main paths, each with every kernel's launch count set to 0 just
    before it and read just after:
    a. text fan-in (BASELINE width: a 260,000-edit base, 1024 x 250):
       parse (the column bytes kept, checked in one native pass, no op
       decoded), OpLog (the native assembler), DeviceDoc.merge on the card
       (run-native staging: expand_runs decodes the run tables) and
       text(); the text length must equal the generator's count;
       scatter_winners must run (the group table passes the scatter gate),
       sort_winners must not; then, outside the timed window, the per-op
       oracle's log of the same bytes (OpLog.from_changes(fast=False),
       its op decode and its flatten timed beside parse and oplog) must
       equal the native log on every column, props, mark names and value;
       then, on the
       same OpLog, merge_columns with staging="expand" and "dense": all 13
       outputs equal across the three stagings (h2d bytes, host encode and
       decode seconds, launches printed for each; the "expand" staging,
       K9's path, is reported as a path); then DeviceDoc.resolve of the same
       log with transport="packed" (its own launch counts: expand_runs,
       unpack_flags, emit_packed), equal to the dict resolve on READ_FETCH
       (conflicts as > 1), the same text, and its flat vector's bytes
       printed against the dict readback's; then "text view" (h);
    b. record-store fan-in (65,536 records x 8 fields, 1024 x 250): the
       same phases (the oracle's log too), then keys of the records map and map_entries of every
       visible record; the generator's counts (visible records, the votes
       sum, keys with concurrent values) must hold; sort_winners must run,
       scatter_winners must not; the three stagings and the packed
       transport as in (a), the packed document's reads the generator's
       counts; then "records view" (h);
    c. the record store served: the base merged on the card (its launches
       read on their own), then DeviceDoc.apply_batches of the replicas in
       64 batches of 16, with the counts set to 0 just before; every batch
       must launch expand_runs (run-native staging, K1) and splice through
       the native delta extraction (OpLog._extract_delta); every READ_FETCH
       array must equal (b)'s exactly, and the final log a from_changes
       rebuild of its changes from their bytes; then the same 64 batches from the
       same base with staging="dense" (no expand_runs; its base merge's
       launches again read on their own, the counts set to 0 just before
       the batches), equal to (b) too, p50 and max per batch printed
       beside the run-native drain's; a view of the resident base is
       taken before the drain, and "served view" (h) after it;
    d. the input on which the JAX package's packed key merges two groups
       (two map puts, props 64 and 0, P = 16): packed equals dict, and so
       does merge_kernel_condensed(32) (the JAX package's
       merge_kernel_condensed(32, 16) merges them);
    e. condensed document order: merge_kernel_condensed at condensed_caps
       on the padded columns with the actor order, for (a)'s text log, a typing fan-in of the
       same shape (workload.typing_trace; its dict merge by DeviceDoc.merge
       first, the path "typing") and (b)'s record log (no sequence: one
       run); run count and rcap printed; all 13 outputs equal the dict
       merge's; the DeviceDoc built from them reads the same text (the
       generator's counts); linearize_condensed launches (LAUNCHES a
       call, its tour's nodes printed), linearize does not;
    f. the sharded merge (parallel.sharded_merge_columns) over a mesh of
       4 shards on the card (Mesh(["cuda:0"] * 4)), each path against
       the single-device merge_kernel on the same padded columns (all 13
       outputs, exact), wall seconds of both printed, the collectives'
       calls and bytes, and the launches (the sharded kernels must run,
       no single-device merge kernel): "text sharded" (the row-range
       winners, the condensed arm: R and R2 printed), "text sharded
       rows" (the row arm), "typing sharded" and "typing sharded rows"
       (the all_gather bytes per doubling round of both arms and their
       ratio), "records sharded" (the sort-based winners, R = 0) and
       "records sharded packed"; on the one card each doubling loop is
       one call of its rounds entry, held to exactly ``rounds`` launches
       (the range kernels to none), the loops timed in that merge
       between synchronisations ("<path> doubling": the two loops'
       wall, the all_gather bytes delivered and those copied); then
       "text sharded exchange": the row arm's two loops
       through the distinct-card exchange (``sharding._exchange``, a
       range launch per run of shards a round, ``rounds`` each here)
       driven on the one card, equal to the rounds entries; then "text
       mesh doc": (a)'s log less its
       last replica change as two DeviceDocs, one with enable_mesh on the
       card, both applying that change (its full re-resolve: over the
       mesh in one), equal on READ_FETCH and the text; "text sharded 4
       cards" where the machine has four cards, else a line saying why
       not; and after "text sharded rows", "text sharded 16" and "text
       sharded 16 rows": (a)'s merge over Mesh(["cuda:0"] * 16), past the
       fold's one launch of at most 8 tables: each psum and pmax folds in
       passes(16) = 3 mesh_reduce launches, all 13 outputs equal the
       single-device merge's;
    g. with --cards, in place of (a)-(f) and 4-6 but the last line: the
       text fan-in's merge (a), then its sharded merge over four distinct
       cards and over four shards on one card, both linearize arms, each
       twice, each against the single-device merge as in (f);
    i. the cross-document served drain (``cross-doc``, run after (d)): 128
       serve-shaped documents (``workload.serve_workload``: a live text
       and an 8,192-character archive each, one editor typing 40
       characters a cycle, document 0 4,096 in cycle 8), every base
       resident on the card, built three times from the same bytes and
       drained over 16 cycles, in turns each cycle, with the launch counts
       and ``batched.stats()`` set to 0 just before each drain and read just
       after: (a) ``apply_cross_doc`` in packed launches of 32 documents,
       pipelined, fallback_ratio 0.25 (at 0.5 no whale can exist at these
       sizes; see SERVE_FALLBACK); (b) each document's own
       ``apply_batches``; (c) a ``CrossDocBatcher`` fed by one thread a
       document holding its document's lock, generations of 32 flushed
       as two half-launches. After every cycle (a) and (c) equal (b) on
       every READ_FETCH array; after the drain every ``live`` and
       ``archive`` text is the generator's; cycle 1's packed super-batches
       resolved again by the plain CPU merge equal the card's; no packed
       path error, no admitted document on the scalar path, a whale
       peeled in cycle 8, (a) exactly 4 packed launches a cycle and its
       kernels' launches those of its packed merges and whales, (b) those
       of 128 merges a cycle. Printed: each drain's wall per cycle (p50,
       max) and its gc seconds, (a)'s host stages summed (dedup, causal
       order, host pack, sort, splice, pack, launch, readback, scatter,
       whale, overlap) beside (b)'s, useful and padded rows a packed
       launch, each drain's launches. Two more sets of the 128 bases are
       written as ARSN images (``runsnap.encode_snapshot`` of a log built
       from the base chunk) and opened cold on the card (``parse``,
       ``to_oplog``, ``DeviceDoc.resolve``: 256 merges, equal to the
       change-built bases), then drained in the same turns as (d)
       ``apply_cross_doc`` as (a) and (e) each document's own
       ``apply_batches``: after every cycle both equal (b); (d) peels the
       whales (a) peels; after the drain every image is faithful
       (``audit_columns()`` empty) and rows were joined over the
       compressed id runs (``compressed.stats()["ovc_join"]``, read around
       each drain) in (d)'s staged splice and in (e)'s
       ``OpLog.append_changes``; each drain's rows joined so are
       printed with its wall;
    j. cold open (after (e)): the three fan-ins (a), (b) and the typing
       fan-in, each written as an ARSN image of its log and heads,
       parsed, turned into a log (``RunImage.to_oplog``: no op column
       parsed, the run tables installed as the log's compressed image)
       and resolved on the card by ``DeviceDoc.resolve``, with the
       launch counts set to 0 just before the resolve and read just
       after: the log equals the fan-in's on every column (the
       reference keys and unresolved counts too), the six READ_FETCH
       arrays and the read (the text; the records map's keys and every
       128th record's entries) equal the fan-in document's,
       ``audit_columns()`` is empty and the launches are the fan-in
       merge's, kernel for kernel. Printed: the image's bytes beside the
       change bytes and the dense and resident column bytes, the
       document's ``resident_nbytes``, ``dense_nbytes`` and
       ``compress_ratio``, each column's run count and the demoted
       columns, and the seconds of encode, parse, ``to_oplog`` and the
       merge (and gc) beside the fan-in's parse and oplog from chunks;
    k. document catch-up (after (i), before (j)): (a)'s 1,025 change
       chunks parsed and applied by an ``AutoDoc(device="cuda")`` in one
       ``apply_changes`` (the bulk path: no op store built); its
       ``text()`` (the stale read: one merge of the history through the
       kernels) equal to (a)'s text, expand_runs, succ_vis,
       scatter_winners, forest, radix_sort and linearize launched,
       sort_winners not; one local ``splice_text`` and ``commit()`` (the
       op-store rebuild, its document order from the stale read's merge,
       memoised by history length in ``Document._history_merge``: it must
       launch no kernel), the text then (a)'s with the splice applied;
       ``save()`` (its document order from the kernels) and
       ``AutoDoc.load(..., device="cuda")``: the same text and heads, and
       a second ``save()`` byte for byte the first; then (b)'s chunks into
       a ``Document`` the same way, whose first read (``keys`` of the
       records map) materializes the store through sort_winners (not
       scatter_winners): ``keys`` and ``map_entries`` of the records map
       equal (b)'s DeviceDoc's and the generator's counts hold on the
       Document's reads. The logs those merges run on equal (a)'s and
       (b)'s on every column, so (4)'s kernel checks at "text" and
       "records" are at their shapes. Printed: each stage's seconds
       (apply, stale read, rebuild, save, load, and the records' apply,
       materialize, reads) with the collector's seconds in each (a
       collection before each window), and each stage's launches;
    l. sync catch-up (after (k)): a peer ``AutoDoc`` on the card holding
       (a)'s 1,025 chunks and a replica ``AutoDoc`` holding the base chunk
       (260,001 ops) beside a resident ``DeviceDoc.merge`` of it, synced
       by ``SyncSession``s (the replica's with ``device_doc=``) over
       seeded ``FaultyChannel``s that drop, duplicate, reorder, truncate
       and bit-flip frames (SYNC_FAULTS), the replica draining each
       tick's deliveries with ``receive_many``, the launch counts set to
       0 just before and read just after: converged within SYNC_TICKS
       ticks, the feed's launches those of the served path
       (expand_runs, succ_vis, scatter_winners, forest, radix_sort,
       linearize; not sort_winners or the packed transport's), the
       resident document equal on every READ_FETCH array to a fresh
       ``DeviceDoc.merge`` of the replica's history and its text (a)'s,
       the sessions having seen a fault; the replica's stale ``text()``
       (one merge) (a)'s text, then one local edit whose op-store rebuild
       launches no kernel (the stale read's merge, memoised); then the
       same catch-up over reliable ``Channel``s, timed alone. Printed:
       seconds to converge, ticks, frames and bytes each way, each
       session's counts (retries, duplicates, malformed frames, resyncs,
       the device feeds by kind) and the launches;
    m. sync cross-doc (after (l)): (i)'s 128 serve-shaped documents as
       server ``AutoDoc``s on the card, each with a resident
       ``DeviceDoc`` fed by its ``SyncSession``, and 128 client
       ``AutoDoc``s; each of 16 cycles every client applies its cycle's
       delta chunk, then one thread a document (holding its lock) runs
       the conversation, the server draining with ``receive_many(frames,
       now, device_feed=lambda b: batcher.apply(dev, b))`` into one
       ``CrossDocBatcher(mode="1", max_docs=32)`` on the card (as (i)(c)),
       the launch counts and ``batched.stats()`` set to 0 just before each
       cycle and read just after: the launches those of the cycle's packed
       merges and whales, every generation's documents summing to 128, no
       packed path error, a whale in cycle 8; after every cycle each
       server's resident document equal on READ_FETCH to a
       ``DeviceDoc.merge`` of its history, its heads its client's; each
       session fed its document once a cycle, by ``device_feed``.
       Printed: frames and bytes each way, a cycle's wall (p50, max), the
       packed launches a cycle, whales, generations and the launches;
    n. observability (after (i), before (e); ``obs_paths``): (a)'s
       1,025 chunks merged again between ``prof.torch_profile_start`` and
       ``torch_profile_stop`` (``obs/prof.py``: a ``torch.profiler``
       capture with CPU and CUDA activity, a ``record_function`` and an
       NVTX range at every kernel-launch site), inside a ``smoke.window``
       range: the trace (``prof.read_capture``) must hold
       ``amtpu.resolve`` with CUDA kernels inside it, the text (a)'s;
       printed: the window, its kernels and the device busy share (the
       union of the kernel intervals over the window's wall);
    o. the served drain of (c) (the record base, its first
       OBS_SERVED_BATCHES = 16 batches of 16: cut from all 64 to make
       room for (t)) again, one ``prof.cycle`` a batch (a step of
       ``apply_batches``' pipeline: the batch spliced and launched, the
       one before read back): every READ_FETCH array that of a merge on
       the card of the base and those batches' changes, the cycles'
       ``launches`` notes equal to
       ``obs``' ``device.kernel_launches{path=per_doc}``; printed: the
       cycles' ``attributed_frac``, host and device seconds and shares,
       overlap, stages and the collector's seconds inside the cycles; then
       the drain once more under a capture
       (``amtpu.dispatch_async`` 16 times, with kernels) and its busy
       share;
    p. (i)'s 128 documents drained again by ``apply_cross_doc`` as (i)(a),
       one ``prof.cycle`` a cycle (the notes' launches those of
       ``batched.stats()``, no packed-path error, the texts the
       generator's), the same figures printed; then under a capture
       (``amtpu.batched_launch`` 64 times, with kernels) and its busy
       share;
    q. what the instruments cost (``obs_cost``): fresh processes of
       ``chip_smoke.py --obs-cost TREE WORKLOAD`` (the served drain's first
       16 batches through ``apply_batches``, then (p)'s drain), one an
       arm (OBS_COST_ROUNDS) in turns: this tree with spans recorded,
       this tree with ``AUTOMERGE_TPU_SPAN_BUFFER=0`` and, where a parent
       checkout is unpacked under ``build/parent``, the parent; printed: each
       process's served p50 a batch and cross-doc p50 a cycle, and each
       arm's p50 and quartiles over all its batches and cycles;
    r. durable storage (after (m), before (j); ``durable_paths``), on
       (a)'s 1,025 change chunks: written through ``AutoDoc.open(dir,
       mirror=True, fsync="always", device="cuda")`` in a fresh directory
       under the temp dir (all but the last DURABLE_TAIL chunks applied
       and journaled, then fed to the mirror, an initial build through
       the kernels; ``compact()`` writes the ARSN image of the mirror's
       log, no ``compact.image_rebuild``; the tail applied and left in
       the journal; closed); reopened cold with a mirror on the card,
       each step timed (the snapshot and journal read from disk, the
       journal scan, ``parse``, the document's apply of the image's
       changes and of the journal's, ``to_oplog``, the resolve and the
       replay's feed into the mirror; the collector's seconds in the
       window, collected before it), then the mirror's first read and
       the document's (its stale read, one merge): heads, ``doc_digest()``
       and the read equal the fan-in's, the mirror's six READ_FETCH
       arrays (a)'s document's, ``audit_columns()`` empty, the resolve's
       launches the fan-in merge's kernel for kernel, the replay's feed
       and the first read launching the served kernels (expand_runs,
       succ_vis, forest, radix_sort, linearize), DURABLE_TAIL records
       replayed and nothing re-encoded (the page cache warm: nothing
       drops it); then a ``DocStore`` over ``DurableOps``: hot, warm
       (the mirror dropped, its run image kept), cold (closed; the
       compaction ``compact_on_demote`` decides), warm (hydrated on
       access) and hot again (``touch``: promoted from the retained
       image plus the journal's tail, nothing re-encoded), the read and
       READ_FETCH arrays then (a)'s, ``store.promote_resident_bytes``
       and each transition's seconds printed; then a follower directory:
       ``apply_replicated_snapshot`` of the written image, its mirror
       built from the adopted image, and ``apply_replicated`` of the
       journal's tail records with ``device_feed`` into a
       ``CrossDocBatcher(mode="1")``: the cursor persisted, the feed's
       launches the served kernels', the follower's mirror equal to the
       leader's on READ_FETCH, its heads and digest (a)'s. Every number
       beside the card's name and power limit;
    s. the serving layer (after (r), before (j); ``serve_paths``): in
       process, ``SocketRpcServer(host="127.0.0.1", port=0,
       durable_dir=<a temp dir>, workers=8)`` on the card, the batcher at
       its default (``AUTOMERGE_TPU_SERVE_BATCHED=auto``: mirrors on the
       card batch); over TCP with ``clients/python/amtpu_client.py``
       (which imports neither package) SRPC_DOCS durable documents opened
       with ``{"device": true}`` (the GIL switch interval set as
       ``rpc.main`` sets it for a server process, restored after), a
       server session each
       (``syncSessionNew``), and one peer thread a document holding
       (i)/(m)'s serve-shaped base and document i's delta chunks in a CPU
       ``AutoDoc``, driving its ``SyncSession`` against the server
       (``syncSessionReceive`` of its frames, ``syncSessionPoll`` back)
       for the base round, then SRPC_ROUNDS rounds of one delta chunk
       each, the launch counts set to 0 just before the opens and read
       after the rounds; round SRPC_CAPTURE_ROUND under
       ``profileStart`` / ``profileStop`` over the RPC (it holds the
       workers' ``amtpu.batched_launch`` ranges with their kernels), its
       busy share the capture's kernel time over the round's wall. Checked: the
       batcher's packed launches (``batched.stats()`` and
       ``device.kernel_launches{path=batched}`` equal and above 0, no
       packed-path error), no error answer, the served kernels launched;
       every mirror's READ_FETCH arrays equal a ``DeviceDoc`` resolved
       afresh on the card from the document's ``save()`` (over the RPC),
       its live text the generator's, every ``materialize`` its peer's
       ``hydrate()``; the first packed super-batch's columns merged on the
       card equal the plain CPU merge. Then ``storeDemote`` of document 0
       to warm and cold, a request that hydrates it (``docDigest`` by
       name: warm) and one that promotes it (``materialize``: hot), the
       promotion's launches the served kernels', the new mirror equal to
       the one before. Printed: the base round and the delta rounds' p50
       and max, a ``syncSessionReceive`` round trip's p50 and p95, the
       batcher's drain cycles (p50, max, documents a cycle), the busy
       share, the hydration's and the promotion's seconds, requests shed.
       Then a fresh process, ``python -m automerge_tpu_torch.rpc --socket
       127.0.0.1:0 --durable DIR`` (the card: no ``--device``), its
       address read from its ``serving on`` line: ``openDurable``
       with ``{"device": true}``, ``applyChanges`` of (a)'s change
       chunks, ``text`` equal to (a)'s, ``metrics`` counting
       ``device.kernel_launches`` above 0, ``shutdown`` and exit 0;
       printed: spawn to the first answer, the apply and the read. The
       server and the process are stopped on every exit path;
    t. the cluster tier (after (s), before (j); ``cluster_paths``), all in
       process on the one card: group 0 a leader L0 (``ack_replicas=1``)
       and a follower F0, group 1 a leader L1, a ``ClusterRouter`` over
       both (heartbeat CLUSTER_HEARTBEAT s, 3 misses), each node
       ``ClusterNode(..., workers=4)`` with no ``device`` (the card; every
       node's server and batcher checked to be on CUDA), and a spare
       follower F2; the launch counts, ``batched.stats()`` and ``obs`` set
       to 0 once F0 has opened its mirrors (``openDurable {"device":
       true}``: the fan-in and every serve document the ring places on
       group 0) and read at the end. (a)'s 1,025 chunks written through
       the router in CLUSTER_FANIN_PARTS ``applyChanges`` (each acked after
       F0's drain), F0's mirror then (a)'s text and a fresh resolve on the
       card of F0's history on READ_FETCH; CLUSTER_DOCS = 32 serve-shaped
       documents ((s)'s, cut from SERVE_DOCS = 128) by CLUSTER_CLIENTS
       client threads, the base then rounds of one 40-character delta
       chunk, each an ``applyChanges`` through the router (its round trip
       timed, and for group 0 the time from its ack to F0's mirror
       holding the change), round CLUSTER_CAPTURE_ROUND under a capture
       (``amtpu.batched_launch`` ranges and CUDA kernels in the window:
       F0's drains, the round's only launches); after round
       CLUSTER_FAILOVER_ROUND every leader's text the document's model
       and every F0 mirror equal to a fresh resolve of F0's history and
       its model's text; then L0's retained records of group 0's serve
       documents shipped to F2 as one pipelined stream (each document's
       base as a ``replSnapshot``, then every ``replApply`` frame in one
       write): no error, some packed launch of F2's drains holding more
       than one document, F2's mirrors checked the same way. Then L0 is
       stopped; the router promotes F0 (the stop to the first acked
       commit on F0 timed); every write acked before the stop reads back
       through the router, the fan-in's text (a)'s; the remaining rounds
       land on F0 (group 0's documents by ``syncSessionNew`` sessions of
       CPU peers, which feed F0's mirrors through its batcher; group 1's
       by ``applyChanges``), every text through the router then the
       generator's and every F0 mirror its document's; then a serve
       document demoted to warm, and the fan-in, migrate to group 1
       (``clusterMigrate``, timed): texts unchanged through the router, F0
       released both, L1 holds both. Checked too: the phase's launches and
       F0's drains' own (``_feed_repl_mirrors`` wrapped: the served
       kernels, not the packed transport's), ``cluster.repl_apply_batch_size``
       and ``cluster.resync_lock_seconds`` (the seconds a snapshot resync
       holds its document's lock) observed, no
       ``cluster.repl_device_feed_error``, no CUDA error left
       by the nodes' threads. Printed: the layout, the fan-in's acks and
       F0's catch-up, its mirror's first read, the ``applyChanges`` round
       trip (p50, p95), the replication lag (p50, max), F0's drains
       (documents a drain, seconds, packed launches, documents a launch)
       and F2's, the capture's busy share, the failover and migration
       seconds, the phase's seconds;
    u. the command line, the native edit sessions and the dot dump
       (after (t), before (j); ``cli_sessions_paths``), all on the card:
       the fastcall extension built and loaded; the 260,000 edits of
       ``workload.load_trace`` typed one ``splice_text`` at a time through
       an ``AutoDoc`` with the sessions on, a commit every U_COMMIT_EVERY
       = 1,000 edits, the launch counts set to 0 just before and read just
       after (none: each commit leaves the op store stale and keeps its
       session for the next transaction, so nothing rebuilds); then,
       under a capture, ``text()`` (the stale read: one merge, launches
       checked) and ``length()`` (the op-store rebuild from that merge),
       the text the trace's; then the first U_COMPARE_EDITS = 24,000
       edits (cut from 260,000: the Python path types about 5,000 edits
       a second) typed both with the sessions and without them (the
       Python path): ``save()`` byte for byte equal; then (b)'s 65,536
       records (8 fields each) put field by field through
       ``AutoDoc.put``, one commit, and again with the sessions off:
       equal saves, the save's launches checked (a put into a map made
       in the same commit takes the per-op path: that commit would drain
       a session through it); then one field of each record put into a
       flat map made in an earlier commit, through the put cache and its
       map session, and again with the sessions off: equal saves;
       then U_DURABLE_EDITS = 8,192 of the trace's edits typed through
       the sessions into ``AutoDoc.open(dir, mirror=True)``, each
       commit's change fed to the mirror (``DeviceDoc.apply_changes``):
       the mirror, and the one a reopen builds, equal a fresh resolve of
       the history; then ``cli.main`` with ``--device cuda``: ``merge``
       of U_CLI_FILES = 8 files written from (a)'s chunks (each the base
       and 128 replicas' changes: a replica's changes need the base), its
       launches read around it, the merged text (a)'s through
       ``export``; ``examine`` (1,025 changes); ``change`` with a splice
       script on the typed durable document's save (its text then "cli "
       and the trace's); ``metrics``, ``journal-info --verify`` and
       ``compact`` on the typed durable directory; then ``python -m
       automerge_tpu_torch export`` of the merged file as a fresh process
       with no ``--device`` (the card): exit 0 and the in-process export's
       JSON byte for byte; then
       ``visualisation.doc_to_dot`` of a small session-typed document.
       Printed: the typing rate in edits/s and the rebuilds it ran (0),
       the stale read's and the rebuild's seconds and the capture's busy
       share, both paths' rates on the compared prefix, the puts' rates
       both ways, every command's seconds, the process's, and each step's
       launches. U_RECORDS = 16,384 of (b)'s records are put both ways
       (cut from 65,536 to make room for (v));
    v. the C ABI on the card (after (u), before (j); ``capi_paths``): the
       port's cdylib built with g++ (``capi.build``), the five C suites
       and the typist ``capi/type_edits.c`` (as a program and as a
       shared library) with gcc, the seconds printed; the five suites
       and the typist on (u)'s first U_COMPARE_EDITS edits run as six
       processes at once with no ``AUTOMERGE_TPU_TORCH_DEVICE`` (the
       card) and this interpreter's path as ``PYTHONPATH``: each exits 0,
       each suite prints "all assertions passed", the typist's save is
       (u)'s prefix save byte for byte, and each process's seconds, the
       typist's ``am_init`` and its first ``am_text`` (the process's CUDA
       context, the kernels' library and a merge) printed; then in this
       process through ``ctypes`` (``am_init`` joins the running
       interpreter): ``am_load`` of the file (u)'s CLI ``merge`` wrote and
       ``am_text``, the launch counts set to 0 just before and read just
       after, held to one merge of the whole log, the text (a)'s; then
       all 260,000 trace edits typed by the typist's ``type_edits``
       through ``am_splice_text``'s hot-call cache, a commit every
       U_COMMIT_EVERY, no launch while typing, the read after it one
       merge and the trace's text, ``am_save`` (u)'s session-typed save
       byte for byte; then the first U_COMPARE_EDITS edits through
       per-call ``shim.call("splice_text", ...)``, its save (u)'s prefix
       save. Printed: both rates in edits/s, the read's seconds and
       launches, the phase's seconds;
    h. historical views, each ``at`` with the launch counts set to 0 just
       before and read just after, held to what its merge of the whole
       log runs (expand_runs a stack, succ_vis 2, the winners, forest and
       radix_sort, linearize 8, nothing else), its seconds and phases,
       its covered rows and the run counts of its covered column and of
       the packed transport's flags column printed: "text view" at H0
       (the base's heads) and H1 (after the first 512 replicas' changes),
       each view's text and length equal to a DeviceDoc.merge on the card
       of exactly the changes its heads cover, H0's text the base
       generator's, diff(H0, None) applied to hydrate(heads=H0) and
       make_patches() applied to {} both hydrate(), the H1 view's columns
       resolved again with the packed transport ("text view packed":
       unpack_flags on a flags column whose covered bit varies) equal to
       the view; "records view", the same on (b)'s document with the
       records map's entries and hydrate against the merge of the changes
       its heads cover; "served view", (c)'s document at H0 after its
       drain, a new view (the drain dropped the one taken before it, and
       remapped the actor ranks) equal to "records view"'s H0 view;
 4. every kernel against its plain PyTorch version on the same CUDA
    tensors (exact equality: all integer arithmetic) at the shapes of
    each path that runs it: the text fan-in, the record fan-in, the
    last served batch's subset columns (whose prop ids are the whole
    log's), one packed super-batch of (i) ("cross-doc") and the first
    packed super-batch of (s)'s served documents ("served rpc"); at the H1
    text view's columns ("text view": expand_runs at its
    run-native stacks and succ_vis on its covered mask; "text view
    packed": expand_runs, unpack_flags and emit_packed of VIEW_FETCH);
    expand_runs at every stack of run tables the run-native
    staging makes on those three (row stacks, and the record fan-in's
    pred-edge stack: the text's pred columns stay dense), at the stacks
    of the eager-expansion staging on both fan-ins (the delta form, with
    the bool columns) and at the packed transport's; unpack_flags and
    emit_packed at the packed transport of both fan-ins; the condensed
    merge's kernels at the three condensed paths' shapes and the dict
    merge's at the typing fan-in's (linearize
    beside linearize_condensed on one log); the sharded merge's at one
    shard's shapes of "text sharded", "text sharded rows", "typing
    sharded rows", "records sharded" and "text sharded 16" (mesh_reduce
    folding the four or sixteen shards' tables where they lie, sixteen in
    three launches at the psum of the counts and the pmax
    of the winners, its library time torch.stack(parts).sum(0,
    dtype=torch.int32) / .amax(0) from the same tables; cond_expand over
    all P rows in one launch, as a mesh of one card runs it; the range
    kernels at one round of one shard's slice, the rounds entries at the
    whole loop over all nodes, timed on the device too, with a round's
    share of their time and bound; the row arm's rank loop from the
    thread loop's answers, linearize_rank_from_thread and its first round
    linearize_rank_first, held against the reference's rank init then
    rounds); emit_packed timed on the device too; sort_winners also on
    synthetic columns with P > 2^20; the whole merge on the card
    against the plain CPU path on all 13 outputs for that served subset
    and for a small fan-in; expand_runs at every stack and linearize,
    scatter_winners, forest, radix_sort, succ_vis, succ_partial and
    visibility at every path also timed on the device by torch.profiler
    (``device_ms`` beside the CUDA-event ``ms``, and by kernel),
    linearize held to its LAUNCHES launches a call, scatter_winners,
    forest and succ_vis to 2, succ_partial to 1, radix_sort at the
    forest's keys (the element rows' alone, their number printed) over
    the device-side count, and one expand_runs call at the text fan-in's
    first stack and one succ_vis call at the text fan-in timed on the
    host step by step;
 5. one {"kernels": [...]} line: kernel launches on the main paths (their
    sum, and by path), median CUDA-event times of the kernel, its plain
    version and (where one exists) a single PyTorch call computing the
    same function (expand_runs: torch.searchsorted and a gather), and the
    bound: the larger of the bytes the function must move over 3.35 TB/s
    and its integer operations over the int32 rate (``work``); the
    top-level numbers are those of the first path that runs the kernel,
    ``by_path`` has each path's (and each stack's, for expand_runs);
 6. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The data sheet's 67 TFLOP/s float32 counts an FMA as two operations on
# 128 float32 lanes per SM; an SM has 64 int32 lanes, one operation each.
INT32_OPS_PER_S = 67e12 / 4

# The BASELINE fan-in: a 260,000-edit base and 1024 replicas x 250 edits.
BASE_EDITS, REPLICAS, PER_REPLICA = 260_000, 1024, 250
# The record store: 65,536 records of 8 fields, 1024 replicas x 250 ops,
# served in batches of 16.
RECORDS, RECORD_REPLICAS, RECORD_PER_REPLICA, RECORD_BATCH = 65_536, 1024, 250, 16
WIDE_P = (1 << 20) + 12_345  # sort_winners past 2^20 rows
REPS = 20  # timed calls per kernel


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, tries: int = 3) -> tuple:
    """(device ms per call summed over its kernels and memsets, {kernel:
    ms per call}) of ``fn()`` from torch.profiler over ``reps`` calls
    after a warm-up: the card's own time, without the host's. The
    profiler now and then records no device activity at all; such a
    window is profiled again, up to ``tries`` times, and then reported
    as (None, {}): not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if t > 0:
                per[e.key[:60]] = t / reps / 1e3
        if per:
            return sum(per.values()), per
    return None, {}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def work(name: str, args, out):
    """(bytes, int32 operations) the function ``name`` must do on these
    inputs: each per-row column read once in full, a gathered input only
    at the distinct indices this run's data reaches, each output written
    once; the operations a minimal count per row, edge or comparison."""
    from automerge_tpu_torch.ops.oplog import PAD_ACTION
    from automerge_tpu_torch.types import Action

    def distinct(idx) -> int:
        return int(torch.unique(idx).numel())

    if name == "succ_vis":
        action, value_tag, _value_i32, covered, pred_src, pred_tgt = args
        P, Q = action.numel(), pred_src.numel()
        src = pred_src.long().clamp(0, P - 1)
        inc = ((pred_tgt >= 0) & (pred_tgt < P) & covered[src]
               & (action[src] == Action.INCREMENT))
        read = nbytes(pred_src, pred_tgt, action, covered)
        # value_i32 only at the sources of counted increment edges, and
        # value_tag only at their targets (is the target a counter put?)
        return (read + 4 * distinct(src[inc]) + 4 * distinct(pred_tgt[inc])
                + nbytes(*out), 3 * Q + 6 * P)
    if name in ("scatter_winners", "sort_winners"):
        action, insert, elem_ref, obj_dense, prop, _width, visible = args[:7]
        winner = out[0]
        elem_vis = insert & (action != PAD_ACTION) & (winner >= 0)
        read = nbytes(action, insert, elem_ref, obj_dense, prop, visible)
        # width only at the winners of visible elements
        return (read + 4 * distinct(winner[elem_vis]) + nbytes(*out),
                10 * action.numel())
    if name == "radix_sort":
        n = args[3]  # the keys sorted: the first n of the buffer
        return 16 * n, n * max(n - 1, 1).bit_length()
    if name == "forest":
        P = args[0].numel()
        # a comparison sort of the element rows' keys alone
        n = int(out[0].sum())
        return nbytes(*args, *out), 10 * P + n * max(n - 1, 1).bit_length()
    if name == "linearize":
        first_child, next_sib, is_elem, elem_ref, obj_dense = args
        P = is_elem.numel()
        # first_child and next_sib over the element rows [0, P), and
        # first_child at the object roots P + obj_dense the elements reach
        read = (nbytes(first_child[:P], next_sib[:P], is_elem, elem_ref, obj_dense)
                + 4 * distinct(obj_dense[is_elem]))
        return read + nbytes(*out), 10 * P
    if name == "linearize_condensed":
        _first_child, _next_sib, is_elem, elem_ref, obj_dense, aorder = args[:6]
        P = is_elem.numel()
        n_elem = int(is_elem.sum())
        parents = elem_ref[is_elem]
        # is_elem and the actor-order slots in full; elem_ref, next_sib and
        # obj_dense at the element rows; first_child at the element parents
        # (the chain test) and at the object roots the elements reach
        read = (nbytes(is_elem, aorder) + 3 * 4 * n_elem
                + 4 * distinct(parents[(parents >= 0) & (parents < P)])
                + 4 * distinct(obj_dense[is_elem]))
        return read + nbytes(*out), 2 * P + 12 * n_elem
    if name == "expand_runs":
        W, C, S, n, _bools = args
        K, rcap = W.shape
        read = nbytes(W, C) + (nbytes(S) if S is not None else 0)
        # a binary search over rcap run ends per value, then the slope term
        per_value = rcap.bit_length() + (2 if S is not None else 0)
        return read + nbytes(*out), K * n * per_value
    if name == "unpack_flags":
        (flags,) = args
        return nbytes(flags, *out), 6 * flags.numel()
    if name == "emit_packed":
        core, fetch, obj_cap = args
        ins = [core[k][:obj_cap] if k.startswith("obj_") else core[k] for k in fetch]
        return nbytes(*ins, *out), 2 * sum(t.numel() for t in ins)
    return sharded_work(name, args, out, distinct)


def sharded_work(name: str, args, out, distinct):
    """``work`` of the sharded merge's kernels: a slice's rows or nodes
    read in full, the state they gather only at the distinct slots this
    data reaches."""
    from automerge_tpu_torch.kernels.scatter_winners import group_ids
    from automerge_tpu_torch.ops.oplog import PAD_ACTION
    from automerge_tpu_torch.types import Action

    if name == "mesh_reduce":
        parts = args[0]
        parts = list(parts) if not isinstance(parts, torch.Tensor) else [parts]
        # every table read once, the result written once
        return nbytes(*parts, *out), sum(t.numel() for t in parts)
    if name == "succ_partial":
        action, _value_i32, _covered, pred_src, pred_tgt = args
        P = action.numel()
        src = pred_src.long().clamp(0, P - 1)
        hit = (pred_tgt >= 0) & (pred_tgt < P)
        inc = hit & (action[src] == Action.INCREMENT)
        # action and covered at the edges' sources, value_i32 at the
        # increments'
        read = (nbytes(pred_src, pred_tgt) + 5 * distinct(src[hit])
                + 4 * distinct(src[inc]))
        return read + nbytes(*out), 3 * pred_src.numel()
    if name == "visibility":
        return nbytes(*args, *out), 6 * args[0].numel()
    if name == "winners_partial":
        action, insert, elem_ref, obj_dense, prop, visible, r0, count = args[:8]
        sl = slice(r0, r0 + count)
        read = nbytes(action[sl], insert[sl], elem_ref[sl], obj_dense[sl], prop[sl],
                      visible[sl])
        return read + nbytes(*out), 10 * count
    if name == "winners_gather":
        (action, insert, elem_ref, obj_dense, prop, _width, _win, _cnt, r0, count,
         n_objs2, n_props) = args
        sl = slice(r0, r0 + count)
        gid = group_ids(action, insert, elem_ref, obj_dense, prop, n_objs2, n_props)[sl]
        winner = out[0]
        elem_vis = insert[sl] & (action[sl] != PAD_ACTION) & (winner >= 0)
        # win and cnt at the slice's groups, width at its visible winners
        read = (nbytes(action[sl], insert[sl], elem_ref[sl], obj_dense[sl], prop[sl])
                + 8 * distinct(gid) + 4 * distinct(winner[elem_vis]))
        return read + nbytes(*out), 10 * count
    if name == "linearize_init":
        first_child, next_sib, is_elem, elem_ref, Epad = args
        P = is_elem.numel()
        read = nbytes(first_child[:P], next_sib[:P], is_elem, elem_ref)
        return read + nbytes(*out), 5 * Epad
    if name in ("linearize_thread", "linearize_rank"):
        *state, i0, count = args
        link = state[-1]
        j = link[i0:i0 + count].long().clamp(0, link.numel() - 1)
        per_node = sum(t.element_size() for t in state)
        # the slice's state, and the state at the distinct nodes it jumps to
        read = per_node * (count + distinct(j))
        return read + nbytes(*out), (4 if len(state) == 3 else 3) * count
    if name == "linearize_rank_first":
        # the first round from the thread loop's answers: fc_e at the
        # slice's rows and at the distinct rows they step to, ans there
        # too where fc_e is -1 (the sentinel and padding read nothing)
        from automerge_tpu_torch.kernels import linearize as L

        fc_e, ans, P, i0, count = args
        nxt = L.linearize_rank_init_plain(fc_e, ans, P)[1][i0:i0 + count]
        own = torch.arange(i0, i0 + count, device=ans.device)
        j = torch.unique(nxt.long().clamp(0, ans.numel() - 1))

        def read_at(nodes):
            nodes = nodes[nodes < P]
            return 4 * (nodes.numel() + int((fc_e[nodes] == -1).sum()))

        return read_at(own) + read_at(j) + nbytes(*out), 5 * count
    if name in ("linearize_thread_rounds", "linearize_rank_rounds",
                "linearize_rank_from_thread"):
        # the whole loop: each round a full round over all E nodes of the
        # state it reads, run here by the plain version; the links run
        # into chain ends, so a later round gathers at fewer distinct nodes.
        # The rank loop from the thread loop's answers: its first round
        # reads them
        from automerge_tpu_torch.kernels import linearize as L

        *state, rounds = args
        E = state[0].numel()
        moved = ops = 0
        if name == "linearize_rank_from_thread":
            first = (*state, 0, E)
            state = L.linearize_rank_first_plain(*first)
            moved, ops = sharded_work("linearize_rank_first", first, state, distinct)
            step, rounds = "linearize_rank", rounds - 1
        else:
            step = name[:-len("_rounds")]
        plain = getattr(L, f"{step}_plain")
        for _ in range(rounds):
            nxt = plain(*state, 0, E)
            m, o = sharded_work(step, (*state, 0, E), nxt, distinct)
            moved, ops, state = moved + m, ops + o, nxt
        return moved, ops
    if name == "linearize_final":
        _first_child, is_elem, obj_dense, dist, r0, count = args
        sl = slice(r0, r0 + count)
        # first_child at the objects' roots and dist at their starts
        roots = distinct(obj_dense[sl][is_elem[sl]])
        return (nbytes(is_elem[sl], obj_dense[sl], dist[sl]) + 8 * roots
                + nbytes(*out), 6 * count)
    if name == "cond_init":
        return nbytes(*args, *out), 4 * args[0].numel()
    if name == "cond_succ":
        tail_ans, ans, _chain_id, clen = args
        a = torch.where(tail_ans != -1, tail_ans, ans)
        # chain_id at the distinct rows the chains' successors start at
        return (nbytes(tail_ans, ans, clen) + 4 * distinct(a[a >= 0]) + nbytes(*out),
                4 * ans.numel())
    if name == "cond_expand":
        chain_id, offset, obj_dense, insert, action, _start_chain, cdist, r0, count = args
        sl = slice(r0, r0 + count)
        cid = chain_id[sl]
        # start_chain at the slice's objects, cdist at its chains
        read = (nbytes(chain_id[sl], offset[sl], obj_dense[sl], insert[sl], action[sl])
                + 4 * distinct(obj_dense[sl]) + 4 * distinct(cid[cid >= 0]))
        return read + nbytes(*out), 8 * count
    raise KeyError(name)


def winner_columns(P: int, seed: int, device, max_prop: int = 70_000):
    """Synthetic inputs of the winner kernels at any P: (action, insert,
    elem_ref, obj_dense, prop, width, visible). Map ops (about half) carry
    prop ids up to ``max_prop``, sequence ops run keys over the rows and
    the elem_ref sentinels; a tail of padding rows, as pad_columns makes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = P - P // 64
    is_map = rng.random(P) < 0.5
    action = np.where(rng.random(P) < 0.8, 1, 3).astype(np.int32)
    action[n:] = 15
    insert = ~is_map & (action == 1) & (rng.random(P) < 0.6)
    elem_ref = np.where(is_map, -2, rng.integers(-3, P, P)).astype(np.int32)
    prop = np.where(is_map, rng.integers(0, max_prop, P), -1).astype(np.int32)
    prop[n:], elem_ref[n:] = -1, -2
    obj_dense = rng.integers(0, max(P // 16, 1), P).astype(np.int32)
    width = rng.integers(1, 4, P).astype(np.int32)
    visible = (action == 1) & (rng.random(P) < 0.7)
    cols = (action, insert, elem_ref, obj_dense, prop, width, visible)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in cols)


def group_keys(action, insert, elem_ref, obj_dense, prop):
    """sort_winners' int64 group key per row (csrc/sort_winners.cu
    ``sk_key``), ``((g_obj * 2 + g_kind) << 32) | uint32(g_key + 4)``: the
    keys whose torch.sort is sort_winners' library time."""
    from automerge_tpu_torch.ops.oplog import PAD_ACTION

    P = action.shape[0]
    rows = torch.arange(P, dtype=torch.int64, device=action.device)
    is_map = prop >= 0
    g_obj = torch.where(action != PAD_ACTION, obj_dense.long(), P)
    g_key = torch.where(is_map, prop.long(),
                        torch.where(insert, rows, elem_ref.long()))
    return ((g_obj * 2 + is_map.long()) << 32) | ((g_key + 4) & 0xFFFFFFFF)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired outputs; raises unless 0."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"kernel disagrees with its plain version by {err}")
    return err


def workload(base_edits: int, replicas: int, per_replica: int, make_trace=None):
    """(change chunks, expected text length, text object id, seconds of
    generation and of encoding). ``make_trace(n)`` makes the edit trace
    (default: ``workload.load_trace``)."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.storage.change import build_change

    t0 = time.perf_counter()
    trace = (make_trace or W.load_trace)(base_edits)
    base_ch, elems = W.base_change(trace, base_edits)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = W.BaseInfo(build_change(base_ch), elems)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    reps = W.fanin_changes(base, trace, replicas, per_replica, base_edits)
    t_gen += time.perf_counter() - t0
    t0 = time.perf_counter()
    reps = [build_change(c) for c in reps]
    t_enc += time.perf_counter() - t0
    changes = base.changes + reps
    blobs = [c.raw_bytes for c in changes]
    return blobs, W.expected_text_length(changes), base.text_exid, t_gen, t_enc


def check_small_against_cpu(device) -> None:
    """A small fan-in merged on the card equals the plain CPU path on
    every output."""
    import numpy as np

    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_columns
    from automerge_tpu_torch.ops.oplog import OpLog

    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    log = OpLog.from_changes(base.changes + W.synth_fanin(base, trace, 16, 100, 2000))
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    gpu = merge_columns(log.columns(), device=device, **kw)
    cpu = merge_columns(log.columns(), device="cpu", **kw)
    for k in ALL_OUTPUTS:
        if not np.array_equal(gpu[k], cpu[k]):
            raise AssertionError(f"small fan-in: {k} differs between cuda and cpu")


def record_workload():
    """(base chunk, replica chunks, expected counts, seconds of generation
    and of encoding) of the record store."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.storage.change import build_change

    t0 = time.perf_counter()
    base_ch = W.record_base_change(RECORDS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = build_change(base_ch)
    t_enc = time.perf_counter() - t0
    expect = W.RecordExpect(RECORDS)
    reps = []
    for i in range(RECORD_REPLICAS):
        t0 = time.perf_counter()
        ch = W.record_replica_change(base, RECORDS, i, RECORD_PER_REPLICA, expect)
        t1 = time.perf_counter()
        reps.append(build_change(ch).raw_bytes)
        t_gen += t1 - t0
        t_enc += time.perf_counter() - t1
    return base.raw_bytes, reps, expect.counts(), t_gen, t_enc


def check_launches(path: str, counts: dict, must: tuple, must_not: tuple) -> None:
    from automerge_tpu_torch.kernels.linearize import LAUNCHES

    idle = [k for k in must if counts[k] < 1]
    if idle:
        raise AssertionError(f"{path}: kernels not launched: {idle}")
    if counts["linearize"] % LAUNCHES:
        raise AssertionError(f"{path}: linearize launched {counts['linearize']} "
                             f"kernels, not {LAUNCHES} a call")
    stray = [k for k in must_not if counts[k]]
    if stray:
        raise AssertionError(f"{path}: kernels launched that must not be: {stray}")


def check_call_launches(name: str, launched: int, want: int) -> None:
    if launched != want:
        raise AssertionError(f"{name}: {launched} launches a call, not {want}")


def check_collective_launches(name: str, counts: dict, mesh, scatter: bool,
                              linearize: str, stats=None) -> None:
    """A sharded merge's folds and expansions: one fold a distinct card
    for each psum and pmax (three psums and a pmax past the scatter gate,
    the counts' psum alone below it), each ``passes(mesh.size)``
    ``mesh_reduce`` launches (one up to 8 shards), one ``cond_expand`` a
    run of shards on a card in the condensed arm; on one card (``stats``:
    the collectives' counts) psum and pmax copy nothing."""
    from automerge_tpu_torch.kernels.collectives import passes

    k = len(mesh.distinct)
    check_call_launches(f"{name} mesh_reduce", counts["mesh_reduce"],
                        (4 if scatter else 1) * k * passes(mesh.size))
    check_call_launches(f"{name} cond_expand", counts["cond_expand"],
                        len(mesh.runs) if linearize == "condensed" else 0)
    if stats is not None and k == 1:
        copied = {kind: stats[kind]["copied"] for kind in ("psum", "pmax")}
        if any(copied.values()):
            raise AssertionError(f"{name}: the folds copied bytes on one card: "
                                 f"{copied}")


SHARED = ("succ_vis", "forest", "radix_sort", "linearize")
RUN_NATIVE = SHARED + ("expand_runs",)
PACKED = SHARED + ("expand_runs", "unpack_flags", "emit_packed")
TRANSPORT_ONLY = ("unpack_flags", "emit_packed")
# a merge of (a)'s whole log: the run-native staging's kernels and the
# scatter winners, neither the sort-based winners nor the packed transport
TEXT_MERGE_MUST = (RUN_NATIVE + ("scatter_winners",), ("sort_winners",) + TRANSPORT_ONLY)
# merge_kernel_condensed's kernels, and those it must not launch
CONDENSED = ("succ_vis", "sort_winners", "forest", "radix_sort",
             "linearize_condensed")
NOT_CONDENSED = ("linearize", "scatter_winners", "expand_runs") + TRANSPORT_ONLY
# the sharded merge's (K11): every path, each linearize arm, each winner
# arm, and the single-device kernels it must not launch
MESH_SHARDS = 4
SHARDED_ALL = ("succ_partial", "visibility", "mesh_reduce", "forest", "radix_sort")
SHARDED_CONDENSED = ("cond_init", "cond_succ", "cond_expand")
SHARDED_ROWS = ("linearize_init", "linearize_final")
# the doubling loops by arm: on a mesh of one card one rounds entry a
# loop, over distinct cards a range launch a run of shards a round (the
# row arm's rank loop starts from the thread loop's answers: its first
# round is a kernel of its own)
ONE_CARD = {"condensed": ("linearize_thread_rounds", "linearize_rank_rounds"),
            "rows": ("linearize_thread_rounds", "linearize_rank_from_thread")}
CARDS = {"condensed": ("linearize_thread", "linearize_rank"),
         "rows": ("linearize_thread", "linearize_rank_first", "linearize_rank")}
ONE_CARD_LOOPS = tuple(dict.fromkeys(k for v in ONE_CARD.values() for k in v))
CARDS_LOOPS = tuple(dict.fromkeys(k for v in CARDS.values() for k in v))


def loop_launches(linearize: str, one_card: bool, rounds: int, runs: int) -> dict:
    """The launches of each doubling-loop kernel of the ``linearize`` arm
    in one sharded merge: on one card ``rounds`` a rounds entry; over
    distinct cards a range launch a run of shards a round, the row arm's
    first rank round its own kernel."""
    if one_card:
        return dict.fromkeys(ONE_CARD[linearize], rounds)
    want = dict.fromkeys(CARDS[linearize], rounds * runs)
    if linearize == "rows":
        want.update(linearize_rank_first=runs, linearize_rank=(rounds - 1) * runs)
    return want
SHARDED_SCATTER = ("winners_partial", "winners_gather")
NOT_SHARDED = ("succ_vis", "scatter_winners", "linearize", "linearize_condensed",
               "emit_packed")


def check_stagings(name: str, log, device) -> dict:
    """The log merged under each staging: all 13 outputs equal; the bytes
    each copies, its host encode, its decode on the card and its launches
    printed. Returns the launch counts of the eager-expansion staging
    (K9's path) and the run-native staging's 13 outputs."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, STAGINGS, merge_columns

    kw = dict(n_objs=log.n_objs, n_props=len(log.props), device=device)
    outs, counts = {}, {}
    for staging in STAGINGS:
        phases = {}
        kernels.reset_launches()
        outs[staging] = merge_columns(log.columns(), staging=staging,
                                      phases=phases, **kw)
        counts[staging] = kernels.launch_counts()
        print(f"{name} staging {staging}: h2d_bytes {phases['h2d_bytes']} of "
              f"dense {phases['h2d_dense_bytes']}; encode (_slope_rle) "
              f"{phases.get('encode', 0.0):.6f} s, h2d {phases['h2d']:.6f} s, "
              f"expand (expand_runs) {phases.get('expand', 0.0) * 1e3:.3f} ms; "
              f"launches {json.dumps(counts[staging])}", flush=True)
        decodes = ("expand_runs",) if staging != "dense" else ()
        check_launches(f"{name} staging {staging}", counts[staging],
                       SHARED + decodes,
                       TRANSPORT_ONLY + (("expand_runs",) if not decodes else ()))
    for staging in STAGINGS[1:]:
        for k in ALL_OUTPUTS:
            if not np.array_equal(outs[staging][k], outs[STAGINGS[0]][k]):
                raise AssertionError(f"{name}: {k} differs between staging "
                                     f"{staging} and {STAGINGS[0]}")
    print(f"{name}: the three stagings agree on all 13 outputs", flush=True)
    return counts["expand"], outs[STAGINGS[0]]


def check_packed(name: str, doc, dict_phases, device):
    """DeviceDoc.resolve of ``doc``'s log with the packed transport: its
    READ_FETCH arrays equal ``doc``'s (conflicts as > 1). Returns (packed
    document, its launch counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    kernels.reset_launches()
    phases = {}
    packed = DeviceDoc.resolve(doc.log, device=device, phases=phases,
                               transport="packed")
    counts = kernels.launch_counts()
    n = doc.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        got, want = np.asarray(packed.res[k])[:cut], np.asarray(doc.res[k])[:cut]
        if k == "conflicts":
            got, want = got > 1, want > 1
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: packed {k} differs from the dict path's")
    print(f"{name} packed: READ_FETCH equal to the dict path's (conflicts as "
          f"> 1); read back {phases['d2h_bytes']} bytes in one flat vector "
          f"against the dict path's {dict_phases['d2h_bytes']}; h2d_bytes "
          f"{phases['h2d_bytes']} of dense {phases['h2d_dense_bytes']}", flush=True)
    print(f"{name} packed phases_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"{name} packed launches {json.dumps(counts)}", flush=True)
    check_launches(f"{name} packed", counts, PACKED, ())
    return packed, counts


def text_fanin(name: str, card: str, device, make_trace=None):
    """A text fan-in of BASELINE width (a 260,000-edit base, 1024 x 250)
    from the trace ``make_trace`` makes: parse..read through
    DeviceDoc.merge on the card, its launches read around it (the scatter
    winners must run, the sort-based must not), its text length the
    generator's count. Returns (document, phases, text, text object,
    launch counts, change bytes)."""
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    blobs, expect_len, text_obj, t_gen, t_enc = workload(
        BASE_EDITS, REPLICAS, PER_REPLICA, make_trace)
    print(f"{name} workload: {len(blobs)} changes, {sum(map(len, blobs))} bytes; "
          f"generate {t_gen:.3f} s, encode {t_enc:.3f} s", flush=True)
    kernels.reset_launches()
    phases = {}
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        doc = DeviceDoc.merge(blobs, device=device, phases=phases)
        t1 = time.perf_counter()
        text = doc.text(text_obj)
        t_end = time.perf_counter()
    phases["read"] = t_end - t1
    phases["gc"] = sum(s for _, s in pauses)  # the collector's, in any phase
    counts = kernels.launch_counts()
    report_path(f"{name} fan-in", doc.log, phases, t_end - t0, counts, card)
    if len(text) != expect_len:
        raise AssertionError(f"{name} length {len(text)} != expected {expect_len}")
    check_native_log(f"{name} fan-in", doc.log, blobs)
    check_launches(f"{name} fan-in", counts, RUN_NATIVE + ("scatter_winners",),
                   ("sort_winners",) + TRANSPORT_ONLY)
    print(f"{name}: {len(text)} characters, as the generator counted", flush=True)
    FANINS[name] = {"doc": doc, "phases": phases, "counts": counts,
                    "e2e": t_end - t0, "bytes": sum(map(len, blobs)),
                    "must": RUN_NATIVE + ("scatter_winners",),
                    "read": lambda d: d.text(text_obj), "blobs": blobs,
                    "text_obj": text_obj, "text": text}
    return doc, phases, text, text_obj, counts, blobs


def text_path(card: str, device):
    """(a) the text fan-in: (log, launch counts by path: the fan-in, its
    eager-expansion staging and its packed resolve; the dict merge's 13
    outputs, the text, the text object)."""
    doc, phases, text, text_obj, counts, blobs = text_fanin("text", card, device)
    log = doc.log
    expand_counts, out = check_stagings("text fan-in", log, device)
    packed, packed_counts = check_packed("text fan-in", doc, phases, device)
    if packed.text(text_obj) != text:
        raise AssertionError("text fan-in: the packed document's text differs")
    print("text fan-in packed: the same text", flush=True)
    view_counts, h1_covered = text_view(card, device, doc, blobs, text_obj)
    return log, {"text": counts, "text expand": expand_counts,
                 "text packed": packed_counts, **view_counts}, out, text, text_obj, \
        h1_covered


# the second cut of a historical view: the heads after this many replicas
VIEW_REPLICAS = 512


def view_cuts(blobs, n_base: int) -> dict:
    """{"H0": the heads of the first ``n_base`` changes (the base's), "H1":
    the heads after the next ``VIEW_REPLICAS`` replicas' changes}, each
    as (heads, the change bytes those heads cover: their ancestors, by
    the changes' dependencies)."""
    from automerge_tpu_torch.storage.change import parse_change

    parsed = [parse_change(b)[0] for b in blobs]
    by_hash = {c.hash: c for c in parsed}
    cuts = {}
    for name, k in (("H0", n_base), ("H1", n_base + VIEW_REPLICAS)):
        deps = {d for c in parsed[:k] for d in c.dependencies}
        heads = sorted(c.hash for c in parsed[:k] if c.hash not in deps)
        seen, stack = set(), list(heads)
        while stack:
            h = stack.pop()
            if h not in seen:
                seen.add(h)
                stack.extend(by_hash[h].dependencies)
        cuts[name] = heads, [b for c, b in zip(parsed, blobs) if c.hash in seen]
    return cuts


def view_at(name: str, card: str, doc, heads, winners: str):
    """One historical view ``doc.at(heads)`` on the card, the launch counts
    set to 0 just before and read just after, held to what its merge of
    the whole log runs: the run-native staging's ``expand_runs`` (one
    launch a stack of run tables), ``succ_vis`` on the clock mask,
    ``winners``, ``forest`` and its ``radix_sort``, ``linearize``, and no
    other kernel. Prints its seconds, its phases, its covered rows and
    the run counts of its covered column and of the packed transport's
    flags column. Returns (view, launch counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.ops.merge import _encode_columns, _flags_column

    gc.collect()
    phases = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    view = doc.at(heads, phases=phases)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    cols = doc.log.padded_columns(covered=view.covered)
    _, groups = _encode_columns(cols, run_native=True)
    stacks = len(groups)
    coded = next((cls for (_, cls), g in groups.items()
                  if "covered" in [k for k, _, _ in g]), "dense")
    flags = _flags_column(cols)

    def runs(x) -> int:
        return 1 + int(np.count_nonzero(np.diff(x.astype(np.int64))))

    print(f"{name}: at {len(heads)} heads, {int(view.covered.sum())} of "
          f"{doc.log.n} rows covered; resolve {seconds:.6f} s on {card}; "
          f"phases_s " + json.dumps({k: round(v, 6) for k, v in phases.items()
                                     if isinstance(v, float)}), flush=True)
    print(f"{name}: covered column {runs(cols['covered'])} runs (staged "
          f"{coded}); flags column {runs(flags)} runs (all covered: "
          f"{runs(_flags_column(doc.log.padded_columns()))})", flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)
    want = {"succ_vis": SV_LAUNCHES, "forest": FOREST_LAUNCHES,
            "linearize": L.LAUNCHES, "expand_runs": stacks,
            winners: SW_LAUNCHES if winners == "scatter_winners" else SO_LAUNCHES}
    for k, n in want.items():
        check_call_launches(f"{name} {k}", counts[k], n)
    check_launches(name, counts, tuple(want) + ("radix_sort",),
                   tuple(k for k in counts if k not in want and k != "radix_sort"))
    return view, counts


def check_view_merge(name: str, card: str, device, doc, heads, covered_blobs, read):
    """A view against an independent merge on the card of exactly the
    changes its heads cover: ``read(d, heads)`` of both equal, and
    ``hydrate``. Prints the seconds of each read."""
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    t0 = time.perf_counter()
    got = read(doc, heads)
    t1 = time.perf_counter()
    got_h = doc.hydrate(heads=heads)
    t2 = time.perf_counter()
    ref = DeviceDoc.merge(covered_blobs, device=device)
    t3 = time.perf_counter()
    if read(ref, None) != got:
        raise AssertionError(f"{name}: reads differ from a merge of the "
                             f"{len(covered_blobs)} changes its heads cover")
    if ref.hydrate() != got_h:
        raise AssertionError(f"{name}: hydrate differs from a merge of the "
                             f"changes its heads cover")
    print(f"{name}: reads {t1 - t0:.6f} s, hydrate {t2 - t1:.6f} s on {card}; "
          f"equal to a merge on the card of the {len(covered_blobs)} changes its "
          f"heads cover ({t3 - t2:.3f} s)", flush=True)


def check_patches(name: str, card: str, doc, h0) -> None:
    """``diff(H0, None)`` applied to ``hydrate(heads=H0)`` gives
    ``hydrate()``, and ``make_patches`` applied to {} too; their seconds
    printed."""
    from automerge_tpu_torch.patches import apply_patches

    now = doc.hydrate()
    before = doc.hydrate(heads=h0)
    t0 = time.perf_counter()
    patches = doc.diff(h0, None)
    t1 = time.perf_counter()
    applied = apply_patches(before, patches)
    t2 = time.perf_counter()
    made = doc.make_patches()
    t3 = time.perf_counter()
    if applied != now:
        raise AssertionError(f"{name}: diff(H0) applied to H0 is not the document")
    if apply_patches({}, made) != now:
        raise AssertionError(f"{name}: make_patches applied to {{}} is not the "
                             "document")
    print(f"{name}: diff(H0, None) {len(patches)} patches {t1 - t0:.6f} s, "
          f"applied {t2 - t1:.6f} s; make_patches {len(made)} patches "
          f"{t3 - t2:.6f} s on {card}; both give hydrate()", flush=True)


def text_view(card: str, device, doc, blobs, text_obj):
    """(h) The text fan-in's document at H0 (the base's heads) and at H1
    (after the first ``VIEW_REPLICAS`` replicas): each view's text and
    length equal a merge on the card of exactly the changes its heads
    cover, H0's text the base generator's; ``diff(H0)`` applied to
    ``hydrate(heads=H0)`` is ``hydrate()``; the H1 view's columns resolved
    with the packed transport (``unpack_flags`` on its flags column) equal
    the view. Returns (launch counts by path, the H1 view's covered
    mask)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import merge_columns

    t0 = time.perf_counter()
    cuts = view_cuts(blobs, 1)
    base_ch, elems = W.base_change(W.load_trace(BASE_EDITS), BASE_EDITS)
    base_text = "".join(base_ch.ops[c - 1].value.value for c, _ in elems)
    print(f"text view: cuts and the base generator's text {time.perf_counter() - t0:.3f} s",
          flush=True)
    counts = {}

    def read(d, heads):
        return d.text(text_obj, heads=heads), d.length(text_obj, heads=heads)

    for cut, path in (("H0", "text view H0"), ("H1", "text view")):
        heads, covered = cuts[cut]
        view, counts[path] = view_at(f"text view {cut}", card, doc, heads,
                                     "scatter_winners")
        check_view_merge(f"text view {cut}", card, device, doc, heads, covered, read)
        if cut == "H0" and view.text(text_obj) != base_text:
            raise AssertionError("text view H0: the text is not the base generator's")
    print(f"text view H0: the base generator's text, {len(base_text)} characters",
          flush=True)
    check_patches("text view", card, doc, cuts["H0"][0])

    h1 = doc.at(cuts["H1"][0])
    log = doc.log
    kernels.reset_launches()
    packed = merge_columns(log.padded_columns(covered=h1.covered),
                           fetch=DeviceDoc.VIEW_FETCH, n_objs=log.n_objs,
                           n_props=len(log.props), device=device, transport="packed")
    counts["text view packed"] = kernels.launch_counts()
    check_launches("text view packed", counts["text view packed"], PACKED, ())
    for k in DeviceDoc.VIEW_FETCH:
        cut = log.n_objs + 2 if k.startswith("obj_") else log.n
        got, want = np.asarray(packed[k])[:cut], np.asarray(h1.res[k])[:cut]
        if k == "conflicts":
            got, want = got > 1, want > 1
        if not np.array_equal(got, want):
            raise AssertionError(f"text view packed: {k} differs from the view's")
    print("text view packed: the H1 view's columns through the packed transport "
          "(unpack_flags on its flags column) equal the view (conflicts as > 1); "
          f"launches {json.dumps(counts['text view packed'])}", flush=True)
    return counts, h1.covered


def report_path(name, log, phases, e2e, counts, card) -> None:
    padded = log.padded_columns()
    print(f"{name}: ops {log.n}, P {len(padded['action'])}, "
          f"Q {len(padded['pred_src'])}, pred edges {len(log.pred_src)}, "
          f"objects {log.n_objs}, keys {len(log.props)}", flush=True)
    print(f"{name} phases_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"{name} end to end (parse..read): {e2e:.3f} s, "
          f"{log.n / e2e:.1f} ops/s on {card}", flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)


def check_native_log(name: str, log, blobs) -> None:
    """The per-op oracle's log of the same change bytes
    (OpLog.from_changes(fast=False): every op decoded and flattened in
    Python) equals the native ``log`` on every column, props, mark names
    and value; its seconds printed beside the native path's."""
    from automerge_tpu_torch.ops.oplog import OpLog
    from automerge_tpu_torch.storage.change import parse_change

    t0 = time.perf_counter()
    changes = [parse_change(b)[0] for b in blobs]
    t1 = time.perf_counter()
    for ch in changes:
        list(ch.ops)  # the per-op decode the parser used to do
    t2 = time.perf_counter()
    oracle = OpLog.from_changes(changes, fast=False)
    t3 = time.perf_counter()
    check_logs_equal(f"{name} oracle", log, oracle)
    print(f"{name} oracle (per-op): parse {t1 - t0:.6f} s + op decode "
          f"{t2 - t1:.6f} s, oplog (flatten) {t3 - t2:.6f} s; equal to the "
          f"native log on every column, props, mark names and value", flush=True)
    # the two native builders of the log, in turns, each from a fresh parse
    # (so each decodes the column caches): the assembler (from_changes's
    # route here) and the batch extraction forced
    builders = {"assembler": lambda chs: OpLog.from_changes(chs),
                "batch extraction": lambda chs: OpLog._collect_fast(*OpLog._start(chs))}
    times = {k: [] for k in builders}
    for k in ("assembler", "batch extraction", "batch extraction", "assembler"):
        fresh = [parse_change(b)[0] for b in blobs]
        t0 = time.perf_counter()
        built = builders[k](fresh)
        times[k].append(time.perf_counter() - t0)
        check_logs_equal(f"{name} {k}", built, oracle)
    print(f"{name} oplog builders, in turns: " + "; ".join(
        f"{k} {', '.join(f'{t:.6f}' for t in v)} s" for k, v in times.items())
        + "; each equal to the oracle's log", flush=True)


LOG_COLUMNS = ("id_key", "obj_key", "obj_table", "obj_dense", "prop", "elem_ref",
               "action", "insert", "value_tag", "value_int", "width", "expand",
               "mark_name_idx", "pred_src", "pred_tgt")


def check_logs_equal(name: str, got, want) -> None:
    import numpy as np

    if (got.n, got.n_objs) != (want.n, want.n_objs):
        raise AssertionError(f"{name}: {got.n} rows, {got.n_objs} objects, not "
                             f"{want.n}, {want.n_objs}")
    for k in ("props", "mark_names", "actors"):
        if list(getattr(got, k)) != list(getattr(want, k)):
            raise AssertionError(f"{name}: {k} differ")
    for k in LOG_COLUMNS:
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{name}: column {k} differs")
    for i in range(got.n):
        if tuple(got.values[i]) != tuple(want.values[i]):
            raise AssertionError(f"{name}: value of row {i} differs")


def record_paths(card: str, device):
    """(b) the record-store fan-in and (c) the record store served:
    (fan-in log, the last served batch's subset, launch counts of each,
    the fan-in's dict merge outputs, the generator's counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.oplog import OpLog, pad_columns
    from automerge_tpu_torch.storage.change import parse_change

    base, reps, expect, t_gen, t_enc = record_workload()
    print(f"record workload: {1 + len(reps)} changes, "
          f"{len(base) + sum(map(len, reps))} bytes; generate {t_gen:.3f} s, "
          f"encode {t_enc:.3f} s; expected {json.dumps(expect)}", flush=True)

    # (b) fan-in
    kernels.reset_launches()
    phases = {}
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        doc = DeviceDoc.merge([base] + reps, device=device, phases=phases)
        t1 = time.perf_counter()
        got = W.record_counts(doc)
        t_end = time.perf_counter()
    phases["read"] = t_end - t1
    phases["gc"] = sum(s for _, s in pauses)  # the collector's, in any phase
    fanin_counts = kernels.launch_counts()
    report_path("record fan-in", doc.log, phases, t_end - t0, fanin_counts, card)
    if got != expect:
        raise AssertionError(f"record fan-in read {got}, generator counted {expect}")
    check_native_log("record fan-in", doc.log, [base] + reps)
    check_launches("record fan-in", fanin_counts, RUN_NATIVE + ("sort_winners",),
                   ("scatter_winners",) + TRANSPORT_ONLY)
    print(f"record fan-in: {json.dumps(got)}, as the generator counted", flush=True)

    def sample_reads(d):
        """keys of the records map and map_entries of every 128th record"""
        keys = d.keys(W.RECORDS_OBJ)
        entries = d.map_entries(W.RECORDS_OBJ)
        return keys, [d.map_entries(rec) for _, (_, _, rec), _ in entries[::128]]

    FANINS["records"] = {"doc": doc, "phases": phases, "counts": fanin_counts,
                         "e2e": t_end - t0,
                         "bytes": len(base) + sum(map(len, reps)),
                         "must": RUN_NATIVE + ("sort_winners",), "read": sample_reads,
                         "blobs": [base] + reps, "expect": expect}
    expand_counts, fanin_out = check_stagings("record fan-in", doc.log, device)
    packed, packed_counts = check_packed("record fan-in", doc, phases, device)
    if W.record_counts(packed) != expect:
        raise AssertionError("record fan-in: the packed document's reads differ "
                             "from the generator's counts")
    print("record fan-in packed: reads as the generator counted", flush=True)
    view_counts, h0, h0_view = records_view(card, device, doc, [base] + reps)

    # (c) served: the base resident on the card, then 64 batches of 16
    batches = W.record_batches(reps, RECORD_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    served = DeviceDoc.merge([base], device=device)
    t_base = time.perf_counter() - t0
    n_base = served.log.n
    base_counts = kernels.launch_counts()
    print(f"record served base launches {json.dumps(base_counts)}", flush=True)
    check_launches("record served base", base_counts, RUN_NATIVE + ("sort_winners",),
                   ("scatter_winners",) + TRANSPORT_ONLY)
    # a view of the resident base before the drain, which must drop it
    pre_view = served.at(h0)
    # note each batch's subset (its dirty objects) to check the kernels at
    # a served batch's shapes afterwards, and each batch's expand_runs
    # launches
    dirty_sets = []
    batch_decodes = []
    deltas = []  # rows of each native delta extraction
    dispatch = DeviceDoc._dispatch_async
    step = DeviceDoc._pipeline_step
    extract_delta = OpLog._extract_delta

    def noting_dispatch(self, dirty, phases=None):
        handle = dispatch(self, dirty, phases)
        subset = handle is not None and not handle.get("fallback")
        dirty_sets.append(np.array(dirty, np.int64) if subset else None)
        return handle

    def counting_step(self, chs, inflight, phases=None, t0=None):
        before = kernels.launch_counts()["expand_runs"]
        out = step(self, chs, inflight, phases, t0)
        batch_decodes.append(kernels.launch_counts()["expand_runs"] - before)
        return out

    def noting_delta(self, fresh, rank_of):
        r = extract_delta(self, fresh, rank_of)
        deltas.append(len(r["id_key"]))
        return r

    phases = {}
    DeviceDoc._dispatch_async = noting_dispatch
    DeviceDoc._pipeline_step = counting_step
    OpLog._extract_delta = noting_delta
    try:
        kernels.reset_launches()
        t1 = time.perf_counter()
        applied = served.apply_batches(batches, phases)
        t_end = time.perf_counter()
        served_counts = kernels.launch_counts()
    finally:
        DeviceDoc._dispatch_async = dispatch
        DeviceDoc._pipeline_step = step
        OpLog._extract_delta = extract_delta
    seconds = phases.pop("batches")
    print(f"record served: base merge {t_base:.3f} s, {len(batches)} batches of "
          f"{RECORD_BATCH}: {t_end - t1:.3f} s, per batch p50 "
          f"{statistics.median(seconds):.6f} s max {max(seconds):.6f} s on {card}",
          flush=True)
    print("record served stages_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"record served launches {json.dumps(served_counts)}", flush=True)
    print(f"record served expand_runs launches per batch {batch_decodes}", flush=True)
    if applied != len(reps):
        raise AssertionError(f"served {applied} of {len(reps)} changes")
    check_launches("record served", served_counts, RUN_NATIVE + ("sort_winners",),
                   ("scatter_winners",) + TRANSPORT_ONLY)
    if len(batch_decodes) != len(batches) or min(batch_decodes) < 1:
        raise AssertionError(f"a served batch launched no expand_runs: {batch_decodes}")
    if len(deltas) != len(batches) or sum(deltas) != served.log.n - n_base:
        raise AssertionError(f"the served batches did not all splice through the "
                             f"native delta: {len(deltas)} extractions of "
                             f"{sum(deltas)} rows")
    print(f"record served: {len(deltas)} native delta extractions, "
          f"{sum(deltas)} rows", flush=True)
    check_served_equal("record served", served, doc, expect)
    t0 = time.perf_counter()
    rebuilt = OpLog.from_changes([parse_change(c.raw_bytes)[0]
                                  for c in served.log.changes])
    check_logs_equal("record served rebuild", served.log, rebuilt)
    print(f"record served: the spliced log equals a from_changes rebuild of its "
          f"changes ({time.perf_counter() - t0:.3f} s)", flush=True)
    view_counts["served view"] = served_view(card, served, h0, h0_view, pre_view)

    # the same batches from the same base, staged dense
    kernels.reset_launches()
    dense = DeviceDoc.merge([base], device=device, staging="dense")
    dense_base_counts = kernels.launch_counts()
    print(f"record served dense base launches {json.dumps(dense_base_counts)}",
          flush=True)
    check_launches("record served dense base", dense_base_counts,
                   SHARED + ("sort_winners",),
                   ("scatter_winners", "expand_runs") + TRANSPORT_ONLY)
    dense_phases = {}
    kernels.reset_launches()
    t2 = time.perf_counter()
    dense.apply_batches(batches, dense_phases)
    t_dense = time.perf_counter() - t2
    dense_counts = kernels.launch_counts()
    dense_seconds = dense_phases.pop("batches")
    print(f"record served, staging dense: {len(batches)} batches {t_dense:.3f} s, "
          f"per batch p50 {statistics.median(dense_seconds):.6f} s max "
          f"{max(dense_seconds):.6f} s; run-native p50 "
          f"{statistics.median(seconds):.6f} s max {max(seconds):.6f} s "
          f"(same run, {card})", flush=True)
    print("record served dense stages_s " + json.dumps(
        {k: round(v, 6) for k, v in dense_phases.items()}), flush=True)
    print(f"record served dense launches {json.dumps(dense_counts)}", flush=True)
    check_launches("record served dense", dense_counts, SHARED + ("sort_winners",),
                   ("scatter_winners", "expand_runs") + TRANSPORT_ONLY)
    check_served_equal("record served dense", dense, doc, expect)
    # the last batch's subset columns: they are those of the final log
    if len(dirty_sets) != len(batches) or dirty_sets[-1] is None:
        raise AssertionError("the last served batch did not take the subset "
                             "re-resolve")
    dirty = dirty_sets[-1]
    last = (pad_columns(served._subset_cols(served._subset_rows(dirty), dirty),
                        len(dirty)), len(dirty), len(served.log.props))
    counts = {"records": fanin_counts, "records expand": expand_counts,
              "records packed": packed_counts,
              "served base": base_counts, "served": served_counts,
              "served dense base": dense_base_counts, "served dense": dense_counts,
              **view_counts}
    return doc.log, last, counts, fanin_out, expect


def records_view(card: str, device, doc, blobs):
    """(h) The record store's fan-in document at H0 (the base's heads) and
    H1 (after the first ``VIEW_REPLICAS`` replicas): each view's
    ``map_entries`` of the records map and ``hydrate`` equal a merge on
    the card of exactly the changes its heads cover; ``diff(H0)`` applied
    to ``hydrate(heads=H0)`` is ``hydrate()``. Returns (launch counts by
    path, H0, the H0 view)."""
    from automerge_tpu_torch import workload as W

    cuts = view_cuts(blobs, 1)
    counts, views = {}, {}

    def read(d, heads):
        return d.map_entries(W.RECORDS_OBJ, heads=heads)

    for cut, path in (("H0", "records view H0"), ("H1", "records view")):
        heads, covered = cuts[cut]
        views[cut], counts[path] = view_at(f"records view {cut}", card, doc, heads,
                                           "sort_winners")
        check_view_merge(f"records view {cut}", card, device, doc, heads, covered,
                         read)
    check_patches("records view", card, doc, cuts["H0"][0])
    return counts, cuts["H0"][0], views["H0"]


def served_view(card: str, served, h0, h0_view, pre_view) -> dict:
    """(h) The served record store at H0 after its drain: a new view (the
    appends dropped the one taken before), resolved with the actor ranks
    as the drain remapped them, equal to the fan-in's H0 view on its
    covered mask, every VIEW_FETCH array, the counters and the records
    map's entries. Returns its launch counts."""
    import numpy as np

    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    view, counts = view_at("served view H0", card, served, h0, "sort_winners")
    if view is pre_view or served._views.get(tuple(sorted(h0))) is not view:
        raise AssertionError("served view: the drain did not drop the view taken "
                             "before it")
    n = h0_view.log.n
    same = np.array_equal(view.covered, h0_view.covered) and np.array_equal(
        view.counter_val[:n], h0_view.counter_val[:n])
    for k in DeviceDoc.VIEW_FETCH:
        cut = h0_view.log.n_objs + 2 if k.startswith("obj_") else n
        same = same and np.array_equal(np.asarray(view.res[k])[:cut],
                                       np.asarray(h0_view.res[k])[:cut])
    if not same or served.map_entries(W.RECORDS_OBJ, heads=h0) != \
            h0_view.map_entries(W.RECORDS_OBJ):
        raise AssertionError("served view: H0 after the drain differs from the "
                             "fan-in's H0 view")
    print(f"served view H0: a new view after the drain ({len(served.log.actors)} "
          "actors ranked), equal to the fan-in's H0 view on covered, VIEW_FETCH, "
          "the counters and the records map", flush=True)
    return counts


def check_served_equal(name: str, served, doc, expect) -> None:
    """A served document equals the one-shot fan-in ``doc`` on every
    READ_FETCH array and the counters, and reads the generator's counts."""
    import numpy as np

    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    n = doc.log.n
    if served.log.n != n or served.log.n_objs != doc.log.n_objs:
        raise AssertionError(f"{name}: log differs in size from the fan-in's")
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        if not np.array_equal(np.asarray(served.res[k])[:cut],
                              np.asarray(doc.res[k])[:cut]):
            raise AssertionError(f"{name}: {k} differs from the fan-in's")
    if not np.array_equal(served.counter_val[:n], doc.counter_val[:n]):
        raise AssertionError(f"{name}: counter values differ from the fan-in's")
    if W.record_counts(served) != expect:
        raise AssertionError(f"{name}: reads differ from the generator's counts")
    print(f"{name} == record fan-in on every READ_FETCH array", flush=True)


def condensed_merge(name: str, log, want: dict, device):
    """(e) One condensed all-device merge of ``log``:
    ``merge_kernel_condensed(condensed_caps(log))`` on its padded columns
    with the actor order, the launch counts set to 0 just before and read
    just after; the run count and rcap printed; all 13 outputs equal to
    ``want``, the dict merge's (its per-object stats cut to n_objs + 2).
    Returns (the DeviceDoc built from the outputs, the launch counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import linearize_condensed as LC
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import (
        ALL_OUTPUTS, condensed_caps, merge_kernel_condensed,
    )

    runs = log.condensed_run_count()
    rcap = condensed_caps(log)
    t0 = time.perf_counter()
    cols = log.padded_columns(include_aorder=True)
    P = len(cols["action"])
    print(f"{name}: {runs} chain runs of {int(np.count_nonzero(log.insert))} "
          f"elements ({log.n} ops, P {P}); rcap {rcap}; "
          f"actor order and padding {time.perf_counter() - t0:.6f} s", flush=True)
    c = columns_from_numpy(cols, device)
    phases = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = merge_kernel_condensed(rcap)(c, phases)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"{name}: merge and readback {seconds:.6f} s; phases_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)
    check_launches(name, counts, CONDENSED, NOT_CONDENSED)
    check_call_launches(f"{name} linearize_condensed",
                        counts["linearize_condensed"], LC.LAUNCHES)
    R, X = LC.tour_size(out["first_child"], out["next_sib"], out["is_elem"],
                        c["elem_ref"], c["aorder"])
    print(f"{name}: linearize_condensed {counts['linearize_condensed']} launches "
          f"a call (rcap {rcap}); its tour {R + X} nodes ({R} runs, {X} exit "
          "nodes)", flush=True)
    for k in ALL_OUTPUTS:
        got = res[k][: len(want[k])] if k.startswith("obj_") else res[k]
        if not np.array_equal(got, want[k]):
            raise AssertionError(f"{name}: {k} differs from the dict merge's")
    print(f"{name}: all 13 outputs equal to the dict merge's", flush=True)
    return DeviceDoc(log, res, device=device), counts


def condensed_paths(card, device, text, records):
    """(e) condensed document order: ``text`` = (log, dict outputs, text,
    text object) of (a), ``records`` = (log, dict outputs, the generator's
    counts) of (b); the typing fan-in is made here. Each path's condensed
    merge equals its dict merge on all 13 outputs, and the DeviceDoc built
    from it reads the same text (the generator's counts for the records).
    Returns (the typing log, launch counts by path)."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.merge import merge_columns

    counts = {}
    log, out, txt, text_obj = text
    doc, counts["text condensed"] = condensed_merge("text condensed", log, out, device)
    if doc.text(text_obj) != txt:
        raise AssertionError("text condensed: the text differs from (a)'s")
    print("text condensed: the same text as (a)", flush=True)

    # the typing fan-in, a stand-in for a real editing trace: the dict
    # merge by DeviceDoc.merge (the path "typing"), then all 13 of its
    # outputs from merge_columns for the condensed merge to meet
    doc, _, txt, text_obj, counts["typing"], _ = text_fanin(
        "typing", card, device, W.typing_trace)
    typing_log = doc.log
    out = merge_columns(typing_log.columns(), n_objs=typing_log.n_objs,
                        n_props=len(typing_log.props), device=device)
    doc, counts["typing condensed"] = condensed_merge(
        "typing condensed", typing_log, out, device)
    if doc.text(text_obj) != txt:
        raise AssertionError("typing condensed: the text differs from the dict merge's")
    print("typing condensed: the same text as the dict merge", flush=True)

    log, out, expect = records
    doc, counts["records condensed"] = condensed_merge(
        "records condensed", log, out, device)
    if W.record_counts(doc) != expect:
        raise AssertionError("records condensed: reads differ from the generator's counts")
    print("records condensed: reads as the generator counted", flush=True)
    return typing_log, counts


def single_merge(cols, n_objs: int, n_props: int, device):
    """The single-device merge_kernel of padded columns, dense: (its 13
    outputs, wall seconds from the copy to the card to the readback)."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.merge import merge_kernel

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = merge_kernel(columns_from_numpy(cols, device), n_objs, n_props)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    return res, time.perf_counter() - t0


def sharded_path(name, card, cols, n_objs: int, n_props: int, mesh, single,
                 linearize: str = "condensed", transport: str = "dict"):
    """(f) One sharded merge of padded columns over ``mesh``, the launch
    counts and the collectives' counts set to 0 just before and read just
    after: its kernels must run (the row-range winners where the sharded
    gate passes, the sort-based ones where it fails; the ``linearize``
    arm's loops) and no single-device merge kernel; all 13 outputs equal
    ``single`` = (outputs, seconds) of ``single_merge``; its two doubling
    loops timed in it (``timed_doubling``, whose synchronisations its wall
    includes). Returns (launch counts, the all_gathers as (per-shard
    length, bytes), R2)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS
    from automerge_tpu_torch.parallel import collectives as C
    from automerge_tpu_torch.parallel import sharding as PS

    n = mesh.size
    P, Q = len(cols["action"]), len(cols["pred_src"])
    scatter = PS.sharded_gate(P, n_objs + 2, n_props)
    detail = ""
    R2 = 0
    if linearize == "condensed":
        t0 = time.perf_counter()
        R2, cond = PS.condense_host(cols, n_objs + 2, n)
        detail = (f", R {int(np.count_nonzero(cond['clen']))} chains, R2 {R2} "
                  f"(condense_host on the host {time.perf_counter() - t0:.6f} s)")
    print(f"{name}: {n} shards on {[str(d) for d in mesh.devices]}; P {P}, "
          f"Pl {P // n}, Q {Q}; winners "
          f"{'row-range scatter' if scatter else 'sort-based, replicated'}; "
          f"linearize {linearize}{detail}; transport {transport}", flush=True)
    for d in mesh.distinct:
        torch.cuda.synchronize(d)
    C.reset_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_doubling(mesh) as walls:
        out = PS.sharded_merge_columns(cols, mesh, n_objs=n_objs, n_props=n_props,
                                       transport=transport, linearize=linearize)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    stats, gathers = json.loads(json.dumps(C.stats)), list(C.gathers)
    want, single_s = single
    print(f"{name}: {seconds:.6f} s wall (synchronised: condense, h2d, merge, "
          f"readback) against the single-device merge's {single_s:.6f} s "
          f"(h2d, merge, readback) on {card}", flush=True)
    print(f"{name} collectives {json.dumps(stats)}", flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)
    arm = SHARDED_CONDENSED if linearize == "condensed" else SHARDED_ROWS
    other = tuple(k for k in SHARDED_CONDENSED + SHARDED_ROWS if k not in arm)
    one_card = len(mesh.distinct) == 1
    rounds = L.ceil_log2(R2) + 1 if linearize == "condensed" else L.rounds(P)
    loops = loop_launches(linearize, one_card, rounds, len(mesh.runs))
    idle = tuple(k for k in ONE_CARD_LOOPS + CARDS_LOOPS if k not in loops)
    winners = SHARDED_SCATTER if scatter else ("sort_winners",)
    not_winners = ("sort_winners",) if scatter else SHARDED_SCATTER
    decode = ("expand_runs", "unpack_flags")
    check_launches(name, counts,
                   SHARDED_ALL + arm + tuple(loops) + winners
                   + (decode if transport == "packed" else ()),
                   NOT_SHARDED + other + idle + not_winners
                   + (decode if transport == "dict" else ()))
    for loop, launched in loops.items():
        # one call of `rounds` launches, or a launch a run a round
        check_call_launches(f"{name} {loop}", counts[loop], launched)
    check_collective_launches(name, counts, mesh, scatter, linearize, stats)
    for k in ALL_OUTPUTS:
        if out[k].shape != want[k].shape or not np.array_equal(out[k], want[k]):
            raise AssertionError(f"{name}: {k} differs from the single-device merge's")
    print(f"{name}: all 13 outputs equal to the single-device merge's", flush=True)
    (t_thread, b_thread, c_thread), (t_rank, b_rank, c_rank) = walls
    print(f"{name} doubling: {rounds} rounds a loop; wall (host-synchronised) "
          f"thread {t_thread:.6f} s, rank {t_rank:.6f} s, both "
          f"{t_thread + t_rank:.6f} s on {card}; all_gather bytes delivered "
          f"{b_thread + b_rank}, copied {c_thread + c_rank}", flush=True)
    return counts, gathers, R2


@contextlib.contextmanager
def timed_doubling(mesh):
    """Within it, each doubling loop of the sharded merge (``sharding.
    _doubling``) is timed on the host between two synchronisations of the
    mesh's cards (its host driving and its kernels): yields the list of
    (seconds, all_gather bytes it delivered in the reference's terms,
    bytes ``copy_`` moved), one a loop."""
    from automerge_tpu_torch.parallel import collectives as C
    from automerge_tpu_torch.parallel import sharding as PS

    loops = []
    doubling = PS._doubling

    def timed(*args):
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        before = dict(C.stats["all_gather"])
        t0 = time.perf_counter()
        out = doubling(*args)
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        after = C.stats["all_gather"]
        loops.append((time.perf_counter() - t0, after["bytes"] - before["bytes"],
                      after["copied"] - before["copied"]))
        return out

    PS._doubling = timed
    try:
        yield loops
    finally:
        PS._doubling = doubling


@contextlib.contextmanager
def gc_pauses():
    """Within it, the collections of Python's garbage collector: yields
    the list of (generation, seconds), one a collection."""
    pauses, start = [], []

    def on_gc(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append((info["generation"], time.perf_counter() - start.pop()))

    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)


def exchange_path(card, device, log) -> dict:
    """(f) The distinct-card exchange of the doubling loops
    (``sharding._exchange``: each round a range launch per run of shards
    written into its card's own buffers, the other cards' slices copied
    in) driven on the one card over the text fan-in's row arm, where the
    mesh is one run: the launch counts set to 0 just before both loops
    and read just after, the range kernels ``rounds`` launches a loop (the
    rank loop's first round from the thread loop's answers,
    ``linearize_rank_first``) and the rounds entries none, both loops
    equal to the rounds entries'."""
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.parallel import collectives as C
    from automerge_tpu_torch.parallel import default_mesh
    from automerge_tpu_torch.parallel import sharding as PS

    name = "text sharded exchange"
    mesh = default_mesh(devices=[device] * MESH_SHARDS)
    cols = log.padded_columns()
    c = columns_from_numpy({k: cols[k] for k in PS.COLUMN_SPECS}, device)
    P = c["action"].numel()
    El = P // MESH_SHARDS + 1
    rounds = L.rounds(P)
    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    st = L.linearize_init(fo[2], fo[3], fo[0], c["elem_ref"], MESH_SHARDS * El)
    (d,) = mesh.distinct
    torch.cuda.synchronize(device)
    C.reset_stats()
    kernels.reset_launches()
    # the window is short and allocates: a young collection landing in it
    # scanned the earlier phases' young objects (7-8 ms on an H100 host,
    # longer than both loops), so they are collected first; a pause that
    # still falls in the window is printed
    gc.collect()
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        thread = PS._exchange(mesh, L.linearize_thread,
                              tuple({d: t} for t in st[:3]), El, rounds)
        loop = PS.rank_from_thread(P)
        rank = PS._exchange(mesh, loop[0], ({d: st[3]}, thread[0]), El, rounds,
                            loop[2])
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"{name}: the row arm's two loops through the distinct-card exchange "
          f"on {MESH_SHARDS} shards of one card, {rounds} rounds each, Epad "
          f"{MESH_SHARDS * El}: {seconds:.6f} s wall (host-synchronised, "
          f"nothing between) on {card}, of which Python's garbage collector "
          f"{sum(s for _, s in pauses):.6f} s (generations "
          f"{[g for g, _ in pauses]}); collectives {json.dumps(C.stats)}; "
          f"launches {json.dumps(counts)}", flush=True)
    loops = loop_launches("rows", False, rounds, len(mesh.runs))
    check_launches(name, counts, tuple(loops), ONE_CARD_LOOPS)
    for loop, want in loops.items():
        check_call_launches(f"{name} {loop}", counts[loop], want)
    for got, want in ((thread, L.linearize_thread_rounds(*st[:3], rounds)),
                      (rank, L.linearize_rank_from_thread(st[3], thread[0][d], P,
                                                          rounds))):
        if not all(torch.equal(g[d], w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: differs from the rounds entries")
    print(f"{name}: both loops equal to the rounds entries'", flush=True)
    return {name: counts}


def doubling_bytes(gathers, length: int, rounds: int) -> float:
    """all_gather bytes per doubling round (the climb's and the rank's
    averaged): the gathers of ``length`` values per shard."""
    return sum(b for n, b in gathers if n == length) / (2 * rounds)


def mesh_doc_path(card, device, log, text_obj):
    """(f) The text fan-in's log less its last replica change, as two
    documents on the card, one with a mesh of ``MESH_SHARDS`` shards on
    the card (``enable_mesh``, min_rows 0); both apply that change, whose
    ops interleave with the others' (not a tail append), so its
    re-resolve is the full one: over the mesh in the first (its kernels
    must run, no single-device merge's), on the card alone in the other.
    The two equal on every READ_FETCH array and the text. Returns the
    launch counts of both applies."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.parallel import Mesh

    changes = list(log.changes)
    docs, counts = {}, {}
    for mode in ("mesh", "single"):
        t0 = time.perf_counter()
        doc = DeviceDoc.from_changes(changes[:-1], device=device)
        t_build = time.perf_counter() - t0
        if mode == "mesh":
            doc.enable_mesh(devices=[device] * MESH_SHARDS, min_rows=0)
        torch.cuda.synchronize(device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        doc.apply_changes(changes[-1:])
        t_apply = time.perf_counter() - t0
        counts[mode] = kernels.launch_counts()
        print(f"text mesh doc {mode}: OpLog and resolve of {len(changes) - 1} "
              f"changes {t_build:.3f} s; apply of the last change (its full "
              f"re-resolve) {t_apply:.6f} s on {card}; launches "
              f"{json.dumps(counts[mode])}", flush=True)
        docs[mode] = doc
    check_launches("text mesh doc", counts["mesh"],
                   SHARDED_ALL + SHARDED_CONDENSED + ONE_CARD["condensed"]
                   + SHARDED_SCATTER,
                   NOT_SHARDED + CARDS_LOOPS + ("linearize_rank_from_thread",
                                                "sort_winners"))
    check_collective_launches("text mesh doc", counts["mesh"],
                              Mesh([device] * MESH_SHARDS), True, "condensed")
    check_launches("text mesh doc single", counts["single"],
                   RUN_NATIVE + ("scatter_winners",),
                   SHARDED_ALL[:3] + SHARDED_CONDENSED + ONE_CARD_LOOPS
                   + CARDS_LOOPS + SHARDED_SCATTER)
    mesh, single = docs["mesh"], docs["single"]
    n = mesh.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = mesh.log.n_objs + 2 if k.startswith("obj_") else n
        if not np.array_equal(np.asarray(mesh.res[k])[:cut],
                              np.asarray(single.res[k])[:cut]):
            raise AssertionError(f"text mesh doc: {k} differs from the "
                                 "single-device document's")
    if mesh.text(text_obj) != single.text(text_obj):
        raise AssertionError("text mesh doc: the text differs")
    print("text mesh doc: READ_FETCH and the text equal to the single-device "
          "document's", flush=True)
    return {"text mesh doc": counts["mesh"], "text mesh doc single": counts["single"]}


def sharded_paths(card, device, text, typing_log, record_log):
    """(f) The sharded merge (K11) over a mesh of ``MESH_SHARDS`` shards on
    the one card: the text fan-in (both linearize arms), the typing
    fan-in (both arms: the collectives' bytes per doubling round), the
    record fan-in (dict and packed), the mesh document, and the text
    fan-in over four cards where the machine has them. Returns the
    launch counts by path."""
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.parallel import default_mesh

    mesh = default_mesh(devices=[device] * MESH_SHARDS)
    text_log, text_obj = text
    counts = {}
    for name, log, arms in (
            ("text", text_log, (("condensed", "dict"), ("rows", "dict"))),
            ("typing", typing_log, (("condensed", "dict"), ("rows", "dict"))),
            ("records", record_log, (("condensed", "dict"), ("condensed", "packed")))):
        cols = log.padded_columns()
        geom = (log.n_objs, len(log.props))
        single = single_merge(cols, *geom, device)
        per_round = {}
        for linearize, transport in arms:
            path = f"{name} sharded" + ("" if linearize == "condensed" else " rows") + (
                " packed" if transport == "packed" else "")
            counts[path], gathers, R2 = sharded_path(
                path, card, cols, *geom, mesh, single, linearize, transport)
            P = len(cols["action"])
            per_round[linearize] = (
                doubling_bytes(gathers, R2 // MESH_SHARDS, L.ceil_log2(R2) + 1)
                if linearize == "condensed" else
                doubling_bytes(gathers, P // MESH_SHARDS + 1, L.rounds(P)))
        if name == "typing":
            print(f"typing sharded: all_gather bytes per doubling round, condensed "
                  f"arm {per_round['condensed']:.1f}, row arm {per_round['rows']:.1f}, "
                  f"ratio {per_round['rows'] / per_round['condensed']:.2f}", flush=True)
        if name == "text":
            counts.update(sixteen_shards(card, device, cols, geom, single))
    counts.update(exchange_path(card, device, text_log))
    counts.update(mesh_doc_path(card, device, text_log, text_obj))
    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_SHARDS:
        cols = text_log.padded_columns()
        geom = (text_log.n_objs, len(text_log.props))
        counts["text sharded 4 cards"] = sharded_path(
            "text sharded 4 cards", card, cols, *geom, default_mesh(MESH_SHARDS),
            single_merge(cols, *geom, device))[0]
    else:
        print(f"text sharded 4 cards: not run, this machine has {n_cards} CUDA "
              f"device(s); the mesh of {MESH_SHARDS} shards ran on one card",
              flush=True)
    return counts


def sixteen_shards(card, device, cols, geom, single) -> dict:
    """(f) "text sharded 16": the text fan-in's sharded merge over
    ``Mesh([card] * 16)``, both linearize arms, as (f)'s other paths (all
    13 outputs equal the single-device merge's); each psum and pmax
    folds its 16 tables in ``passes(16)`` ``mesh_reduce`` launches.
    Returns the launch counts by path."""
    from automerge_tpu_torch.kernels.collectives import CAP, passes
    from automerge_tpu_torch.parallel import default_mesh

    mesh = default_mesh(devices=[device] * SIXTEEN)
    counts = {}
    for linearize in ("condensed", "rows"):
        path = "text sharded 16" + ("" if linearize == "condensed" else " rows")
        gc.collect()
        counts[path] = sharded_path(path, card, cols, *geom, mesh, single,
                                    linearize)[0]
        print(f"{path}: mesh_reduce {counts[path]['mesh_reduce']} launches, "
              f"{passes(SIXTEEN)} a fold of {SIXTEEN} tables (at most {CAP} a "
              "launch)", flush=True)
    return counts


# the shards of the mesh past the fold's one-launch cap
SIXTEEN = 16


def cards_paths(card, device) -> None:
    """``--cards``: the text fan-in's sharded merge over four distinct
    cards (the default mesh), both linearize arms, beside the same four
    shards on one card and the single-device merge, each run twice (the
    first call on a card pays its context and allocations). Every run is
    held to the single-device merge's 13 outputs as in (f)."""
    from automerge_tpu_torch.parallel import default_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < MESH_SHARDS:
        raise SystemExit(f"chip_smoke --cards: needs {MESH_SHARDS} CUDA devices, "
                         f"found {n_cards}")
    doc = text_fanin("text", card, device)[0]
    cols = doc.log.padded_columns()
    geom = (doc.log.n_objs, len(doc.log.props))
    single = single_merge(cols, *geom, device)
    for where, mesh in (("4 cards", default_mesh(MESH_SHARDS)),
                        ("1 card", default_mesh(devices=[device] * MESH_SHARDS))):
        for linearize in ("condensed", "rows"):
            for rep in (1, 2):
                arm = "" if linearize == "condensed" else " rows"
                sharded_path(f"text sharded {where}{arm}, run {rep}", card, cols,
                             *geom, mesh, single, linearize)


# the fan-in documents (a), (b) and the typing fan-in of (e), held for the
# cold-open phase (j): the document, its phases, its launches, its end to
# end seconds, its change bytes, the kernels it must run, a read
FANINS = {}
COLD_ORDER = ("text", "typing", "records")


def check_ref_keys(name: str, got, want) -> None:
    """The reference-key columns and the unresolved counts agree."""
    import numpy as np

    for k in ("elem_key", "pred_key"):
        g, w = getattr(got, k), getattr(want, k)
        if (g is None) != (w is None) or (g is not None and (
                g.dtype != w.dtype or not np.array_equal(g, w))):
            raise AssertionError(f"{name}: column {k} differs")
    if (got.n_miss_elem, got.n_miss_pred) != (want.n_miss_elem, want.n_miss_pred):
        raise AssertionError(f"{name}: unresolved-reference counts differ")


def cold_open(name: str, card: str, device) -> dict:
    """(j) One fan-in written as an ARSN image and opened cold on the
    card: ``encode_snapshot`` of its log and heads, ``parse``,
    ``to_oplog``, ``DeviceDoc.resolve``, each timed (the collector's
    seconds beside them), the launches counted around the resolve. The
    log equals the fan-in's, the six READ_FETCH arrays and the read
    equal the fan-in document's, the image is faithful (``audit_columns``
    empty) and the launches are the fan-in merge's, kernel for kernel.
    Returns the launch counts."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.storage import runsnap as R

    held = FANINS[name]
    doc = held["doc"]
    heads = doc.current_heads()
    phases = {}
    gc.collect()
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        data = R.encode_snapshot(doc.log, heads)
        t1 = time.perf_counter()
        img = R.parse(data)
        t2 = time.perf_counter()
        log = img.to_oplog()
        t3 = time.perf_counter()
        kernels.reset_launches()
        cold = DeviceDoc.resolve(log, device=device, phases=phases)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    counts = kernels.launch_counts()
    gc_s = sum(s for _, s in pauses)
    check_logs_equal(f"{name} cold open", log, doc.log)
    check_ref_keys(f"{name} cold open", log, doc.log)
    for k in DeviceDoc.READ_FETCH:
        cut = log.n_objs + 2 if k.startswith("obj_") else log.n
        if not np.array_equal(np.asarray(cold.res[k])[:cut], np.asarray(doc.res[k])[:cut]):
            raise AssertionError(f"{name} cold open: {k} differs from the fan-in's")
    t5 = time.perf_counter()
    if held["read"](cold) != held["read"](doc):
        raise AssertionError(f"{name} cold open: the read differs from the fan-in's")
    t_read = time.perf_counter() - t5
    bad = cold.audit_columns()
    if bad:
        raise AssertionError(f"{name} cold open: the image differs from the columns: {bad}")
    if counts != held["counts"]:
        raise AssertionError(f"{name} cold open: launches {json.dumps(counts)}, the "
                             f"fan-in's {json.dumps(held['counts'])}")
    check_launches(f"{name} cold open", counts, held["must"], TRANSPORT_ONLY)
    comp = cold.log._comp
    runs = comp.run_counts()
    fp = held["phases"]
    print(f"{name} cold open: image {len(data)} bytes, change bytes {held['bytes']}, "
          f"dense columns {cold.log.dense_column_nbytes()}, resident columns "
          f"{cold.log.resident_column_nbytes()}; document resident_nbytes "
          f"{cold.resident_nbytes()}, dense_nbytes {cold.dense_nbytes()}, "
          f"compress_ratio {cold.compress_ratio():.6f}", flush=True)
    print(f"{name} cold open runs " + json.dumps(runs) + "; demoted "
          + json.dumps(sorted(k for k, v in runs.items() if v == -1)), flush=True)
    print(f"{name} cold open seconds: encode {t1 - t0:.6f}, parse {t2 - t1:.6f}, "
          f"to_oplog {t3 - t2:.6f}, merge {t4 - t3:.6f} (phases "
          + json.dumps({k: round(v, 6) for k, v in phases.items()})
          + f"), gc {gc_s:.6f}; image to resident log {t3 - t1:.6f} s against the "
          f"fan-in's parse {fp['parse']:.6f} + oplog {fp['oplog']:.6f} = "
          f"{fp['parse'] + fp['oplog']:.6f} s from chunks (fan-in end to end "
          f"{held['e2e']:.6f} s) on {card}", flush=True)
    print(f"{name} cold open: log, reference keys, READ_FETCH and the read "
          f"({t_read:.3f} s) equal the fan-in's; audit_columns() == []; launches "
          f"the fan-in's {json.dumps(counts)}", flush=True)
    return counts


DOC_ACTOR = bytes([0x77]) * 16  # the catching-up replica's actor
# a context manager factory, called with a stage's name, around each timed
# stage of the document catch-up; None: none (scripts/profile_document_torch.py
# sets it to trace the stages)
DOC_STAGE_PROBE = None
DOC_SPLICE = (1234, "<catch-up edit>")  # its local edit: position, text


def document_record_counts(doc, entries) -> dict:
    """The counts of ``workload.RecordExpect`` read through a Document's
    own API: ``entries`` (``map_entries`` of the records map), each
    visible record's ``map_entries`` for the votes sum, and ``get_all`` of
    each scalar field for the keys holding concurrent values."""
    from automerge_tpu_torch import workload as W

    votes = conflicts = 0
    fields = [f for f, _ in W.RECORD_FIELDS]
    for _, (_, _, rec), _ in entries:
        for name, value, _ in doc.map_entries(rec):
            if name == W.COUNTER_FIELD:
                votes += value[1]
        conflicts += sum(1 for f in fields if len(doc.get_all(rec, f)) > 1)
    return {"records": len(entries), "votes": votes, "conflict_keys": conflicts}


def check_memo_rebuild(name: str, counts: dict) -> None:
    """The op-store rebuild right after a stale read at the same history
    length takes its document order from the read's merge
    (``Document._history_merge``): it launches no kernel."""
    launched = {k: v for k, v in counts.items() if v}
    if launched:
        raise AssertionError(f"{name}: the rebuild launched {launched}; it must "
                             "reuse the stale read's merge")


def document_paths(card: str, device) -> dict:
    """(k) the document layer catching up on (a)'s and (b)'s change chunks
    on the card (see the module docstring). Returns the launch counts by
    stage."""
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.core.document import Document
    from automerge_tpu_torch.ops.oplog import OpLog
    from automerge_tpu_torch.storage.change import parse_change
    from automerge_tpu_torch.types import ActorId

    seconds, counts = {}, {}

    def stage(name, fn, path=None):
        """fn() timed after a collection, the collector's seconds inside
        it beside; with ``path``, its launches counted as that path's."""
        gc.collect()
        if path is not None:
            kernels.reset_launches()
        probe = DOC_STAGE_PROBE(name) if DOC_STAGE_PROBE else contextlib.nullcontext()
        with probe, gc_pauses() as pauses:
            t0 = time.perf_counter()
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
        seconds[f"{name} gc"] = sum(s for _, s in pauses)
        if path is not None:
            counts[path] = kernels.launch_counts()
            print(f"{path} launches {json.dumps(counts[path])}", flush=True)
        return out

    text_must = TEXT_MERGE_MUST

    # text: the bulk apply, the stale read, the rebuild, save and load
    held = FANINS["text"]
    blobs, text_obj, text = held["blobs"], held["text_obj"], held["text"]
    doc = AutoDoc(ActorId(DOC_ACTOR), device=device)
    stage("apply", lambda: doc.apply_changes([parse_change(b)[0] for b in blobs]))
    new_ops = sum(len(a.stored.ops) for a in doc.doc.history)
    if not doc.doc._ops_stale or new_ops < doc.doc.BULK_MIN_OPS:
        raise AssertionError(f"text document: {new_ops} ops did not take the bulk path")
    check_logs_equal("text document", OpLog.from_changes(
        [a.stored for a in doc.doc.history]), held["doc"].log)
    stale = stage("stale read", lambda: doc.text(text_obj), "text document read")
    if stale != text:
        raise AssertionError("text document: the stale read differs from (a)'s text")
    if not doc.doc._ops_stale:
        raise AssertionError("text document: the stale read built the op store")
    check_launches("text document read", counts["text document read"], *text_must)
    pos, ins = DOC_SPLICE

    def edit():
        doc.splice_text(text_obj, pos, 0, ins)
        return doc.commit()

    stage("rebuild", edit, "text document rebuild")
    check_memo_rebuild("text document", counts["text document rebuild"])
    want = stale[:pos] + ins + stale[pos:]
    if doc.text(text_obj) != want:
        raise AssertionError("text document: the rebuilt text, edited, is not the "
                             "stale read's with the splice")
    data = stage("save", doc.save, "text document save")
    check_launches("text document save", counts["text document save"], *text_must)
    loaded = stage("load", lambda: AutoDoc.load(data, device=device))
    if loaded.text(text_obj) != want or loaded.get_heads() != doc.get_heads():
        raise AssertionError("text document: the loaded document differs")
    if loaded.save() != data:
        raise AssertionError("text document: a second save differs from the first")
    print(f"text document: {new_ops} ops applied in bulk; the stale read is (a)'s "
          f"{len(stale)} characters; the edited text, the heads and the save "
          f"({len(data)} bytes) survive a load, saved again byte for byte", flush=True)
    del doc, loaded, data

    # records: the first read materializes through sort_winners
    held = FANINS["records"]
    rdoc = Document(ActorId(DOC_ACTOR), device=device)
    stage("records apply", lambda: rdoc.apply_changes(
        [parse_change(b)[0] for b in held["blobs"]]))
    if not rdoc._ops_stale:
        raise AssertionError("records document: the apply built the op store")
    check_logs_equal("records document", OpLog.from_changes(
        [a.stored for a in rdoc.history]), held["doc"].log)
    keys = stage("records materialize", lambda: rdoc.keys(W.RECORDS_OBJ),
                 "records document")
    check_launches("records document", counts["records document"],
                   RUN_NATIVE + ("sort_winners",), ("scatter_winners",) + TRANSPORT_ONLY)
    entries = stage("records reads", lambda: rdoc.map_entries(W.RECORDS_OBJ))
    fan = held["doc"]
    if keys != fan.keys(W.RECORDS_OBJ) or entries != fan.map_entries(W.RECORDS_OBJ):
        raise AssertionError("records document: keys or map_entries differ from (b)'s")
    got = document_record_counts(rdoc, entries)
    if got != held["expect"]:
        raise AssertionError(f"records document read {got}, the generator counted "
                             f"{held['expect']}")
    print(f"records document: {json.dumps(got)}, as the generator counted; keys "
          f"and map_entries of the records map equal (b)'s", flush=True)
    print("document catch-up seconds " + json.dumps(
        {k: round(v, 6) for k, v in seconds.items()}) + f" on {card}", flush=True)
    return counts


# (l) sync catch-up: the replica's faults and tick budget
SYNC_SEED = 5  # a schedule with drops, duplicates, corruption, retries and a resync
SYNC_FAULTS = dict(drop=0.2, dup=0.2, reorder=0.2, truncate=0.05, bitflip=0.05)
SYNC_TICKS = 400
SYNC_ACTORS = (bytes([0x41]) * 16, bytes([0x42]) * 16)  # the peer, the replica


def drive_sessions(sa, sb, ab, ba, settled, max_ticks: int) -> dict:
    """Tick two sessions as ``sync.SyncDriver`` does, the replica ``sb``
    draining each tick's deliveries with ``receive_many``, until
    ``settled()``. Returns the ticks and the frames and bytes each side
    put on the wire."""
    wire = {"ab": [0, 0], "ba": [0, 0]}
    for tick in range(1, max_ticks + 1):
        for sess, ch, way in ((sa, ab, "ab"), (sb, ba, "ba")):
            out = sess.poll(tick)
            if out is not None:
                ch.send(out, tick)
                wire[way][0] += 1
                wire[way][1] += len(out)
        sb.receive_many(ab.drain(tick), tick)
        for data in ba.drain(tick):
            sa.receive(data, tick)
        if settled():
            return {"ticks": tick, "frames_ab": wire["ab"][0], "bytes_ab": wire["ab"][1],
                    "frames_ba": wire["ba"][0], "bytes_ba": wire["ba"][1]}
    raise AssertionError(f"sync: no convergence in {max_ticks} ticks")


def session_counts(sess) -> dict:
    return {k: sess.stats[k] for k in ("sent", "received", "retries", "dups",
                                       "malformed", "resyncs", "resets", "rejected",
                                       "coalesced_batches", "device_feeds")}


def sync_catch_up(device, chunks, faulty: bool) -> tuple:
    """One replica's catch-up over sessions (``faulty``: seeded lossy
    channels, else reliable ones): the peer holds every chunk, the replica
    the base chunk and a resident DeviceDoc of it, fed by its session.
    Returns (the replica, its resident document, the drive's seconds,
    launches and wire counts, the two sessions)."""
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.sync import Channel, FaultyChannel, SyncSession
    from automerge_tpu_torch.types import ActorId

    peer = AutoDoc(ActorId(SYNC_ACTORS[0]), device=device)
    peer.apply_changes(chunks)
    replica = AutoDoc(ActorId(SYNC_ACTORS[1]), device=device)
    replica.apply_changes(chunks[:1])
    resident = DeviceDoc.merge([chunks[0].raw_bytes], device=device)
    sa = SyncSession(peer, epoch=1)
    sb = SyncSession(replica, epoch=2, device_doc=resident)
    if faulty:
        ab = FaultyChannel(seed=SYNC_SEED, **SYNC_FAULTS)
        ba = FaultyChannel(seed=SYNC_SEED + 1, **SYNC_FAULTS)
    else:
        ab, ba = Channel(), Channel()

    def settled():
        return (replica.get_heads() == peer.get_heads() and sa.converged()
                and sb.converged() and not ab.pending and not ba.pending)

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        wire = drive_sessions(sa, sb, ab, ba, settled, SYNC_TICKS)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    wire["gc"] = sum(s for _, s in pauses)
    return replica, resident, seconds, counts, wire, (sa, sb)


def sync_catch_up_paths(card: str, device) -> dict:
    """(l) the text fan-in caught up over sync sessions (see the module
    docstring). Returns the launch counts by path."""
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.storage.change import parse_change

    held = FANINS["text"]
    blobs, text_obj, text = held["blobs"], held["text_obj"], held["text"]
    chunks = [parse_change(b)[0] for b in blobs]
    base_ops = len(chunks[0].ops)
    counts = {}
    served_must = (RUN_NATIVE + ("scatter_winners",), ("sort_winners",) + TRANSPORT_ONLY)
    for faulty, path in ((True, "sync catch-up"), (False, "sync catch-up reliable")):
        replica, resident, seconds, launched, wire, (sa, sb) = sync_catch_up(
            device, chunks, faulty)
        counts[path] = launched
        check_launches(path, launched, *served_must)
        fed = sb.stats["device_feeds"]
        if not any(fed.values()):
            raise AssertionError(f"{path}: the session never fed the resident document")
        if replica.doc._ops_stale is not True:
            raise AssertionError(f"{path}: the catch-up did not take the bulk path")
        fresh = DeviceDoc.merge([replica], device=device)
        check_serve_equal(path, [resident], [fresh], -1)
        if resident.text(text_obj) != text:
            raise AssertionError(f"{path}: the resident document's text is not (a)'s")
        print(f"{path} ({'seeded faults ' + json.dumps(SYNC_FAULTS) if faulty else 'reliable channels'}): "
              f"{len(chunks) - 1} chunks onto a replica holding the base ({base_ops} ops) in "
              f"{seconds:.6f} s, {wire['ticks']} ticks; frames and bytes peer to replica "
              f"{wire['frames_ab']}, {wire['bytes_ab']}, replica to peer {wire['frames_ba']}, "
              f"{wire['bytes_ba']}; gc {wire['gc']:.6f} s on {card}", flush=True)
        print(f"{path} sessions: peer {json.dumps(session_counts(sa))}; replica "
              f"{json.dumps(session_counts(sb))}", flush=True)
        print(f"{path} launches {json.dumps({k: v for k, v in launched.items() if v})}",
              flush=True)
        print(f"{path}: the resident document equals a fresh DeviceDoc.merge of the "
              f"replica's history ({resident.log.n} rows) on READ_FETCH; its text is "
              f"(a)'s", flush=True)
        if not faulty:
            continue
        s = sb.stats
        if s["retries"] + sa.stats["retries"] + s["dups"] + s["malformed"] == 0:
            raise AssertionError(f"{path}: the channels injected no fault the sessions saw")
        # the stale read, then one edit whose rebuild reuses its merge
        kernels.reset_launches()
        t0 = time.perf_counter()
        stale = replica.text(text_obj)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        counts[f"{path} read"] = kernels.launch_counts()
        if stale != text or not replica.doc._ops_stale:
            raise AssertionError(f"{path}: the stale read is not (a)'s text, or it "
                                 "built the op store")
        check_launches(f"{path} read", counts[f"{path} read"],
                       RUN_NATIVE + ("scatter_winners",), ("sort_winners",) + TRANSPORT_ONLY)
        pos, ins = DOC_SPLICE
        gc.collect()
        kernels.reset_launches()
        t0 = time.perf_counter()
        replica.splice_text(text_obj, pos, 0, ins)
        replica.commit()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_edit = time.perf_counter() - t0
        counts[f"{path} rebuild"] = kernels.launch_counts()
        check_memo_rebuild(path, counts[f"{path} rebuild"])
        if replica.text(text_obj) != stale[:pos] + ins + stale[pos:]:
            raise AssertionError(f"{path}: the rebuilt text, edited, is not the stale "
                                 "read's with the splice")
        read_launched = {k: v for k, v in counts[f"{path} read"].items() if v}
        print(f"{path}: the replica's stale read is (a)'s {len(stale)} characters "
              f"({t_read:.6f} s, launches {json.dumps(read_launched)}); its "
              f"first edit rebuilt the op store from that read's merge in "
              f"{t_edit:.6f} s with no launch", flush=True)
    return counts


# (m) the cross-document drain fed by sync sessions
SYNC_SERVE_ACTOR = 0x30  # servers' actors 0x30.., clients' 0xb0..


def converse(client, server, now, feed, wire) -> None:
    """Rounds of client poll, server ``receive_many`` (into ``feed``),
    server poll and client receive until both have converged."""
    for k in range(20):
        frame = client.poll(now + k)
        frames = [frame] if frame is not None else []
        for f in frames:
            wire[0] += 1
            wire[1] += len(f)
        server.receive_many(frames, now + k, device_feed=feed)
        reply = server.poll(now + k)
        if reply is not None:
            wire[2] += 1
            wire[3] += len(reply)
            client.receive(reply, now + k)
        if client.converged() and server.converged():
            return
    raise AssertionError("sync cross-doc: a document's sessions did not converge")


def sync_cross_doc_paths(card: str, device) -> dict:
    """(m) SERVE_DOCS server documents fed by their sync sessions through
    one ``CrossDocBatcher`` (see the module docstring). Returns the launch
    counts by path."""
    import threading

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.storage.change import parse_change
    from automerge_tpu_torch.sync import SyncSession
    from automerge_tpu_torch.types import ActorId

    doc0, cycle0, n0 = SERVE_BURST
    t_phase = time.perf_counter()
    base, deltas, texts = W.serve_workload(
        SERVE_DOCS, SERVE_CYCLES, SERVE_OPS, SERVE_BALLAST, burst={(doc0, cycle0): n0})
    base_ch = parse_change(base)[0]
    servers, clients = [], []
    for i in range(SERVE_DOCS):
        for out, a in ((servers, SYNC_SERVE_ACTOR), (clients, SYNC_SERVE_ACTOR + 0x80)):
            d = AutoDoc(ActorId(bytes([a, i]) * 8), device=device)
            d.apply_changes([base_ch])
            out.append(d)
    devs = [DeviceDoc.merge([base], device=device) for _ in range(SERVE_DOCS)]
    ss = [SyncSession(s, epoch=1, device_doc=d) for s, d in zip(servers, devs)]
    cs = [SyncSession(c, epoch=2) for c in clients]
    wire = [[0, 0, 0, 0] for _ in range(SERVE_DOCS)]
    for i in range(SERVE_DOCS):
        converse(cs[i], ss[i], 0, None, wire[i])
    if any(s.stats["device_feeds"][k] for s in ss for k in s.stats["device_feeds"]):
        raise AssertionError("sync cross-doc: settling the sessions fed a document")
    generations = []

    class NotingBatcher(B.CrossDocBatcher):
        def _flush(self, gen):
            generations.append(len(gen.subs) + len(gen.stages))
            super()._flush(gen)

    batcher = NotingBatcher(mode="1", window_ms=1000.0, max_docs=SERVE_PER_LAUNCH,
                            fallback_ratio=SERVE_FALLBACK, device=device)
    locks = [threading.Lock() for _ in range(SERVE_DOCS)]
    seconds, launches_a_cycle, whales, gens_a_cycle = [], [], [], []
    totals, gcs = {}, 0.0
    wire_before = [list(w) for w in wire]
    t_check = 0.0
    for c in range(SERVE_CYCLES):
        for i in range(SERVE_DOCS):
            clients[i].apply_changes([parse_change(deltas[i][c])[0]])
        errs = []
        now = 100 * (c + 1)

        def worker(i):
            try:
                with locks[i]:
                    converse(cs[i], ss[i], now,
                             lambda b, i=i: batcher.apply(devs[i], b), wire[i])
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        gc.collect()
        kernels.reset_launches()
        B.reset_stats()
        n_gen = len(generations)
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(SERVE_DOCS)]
        with gc_pauses() as pauses:
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        gcs += sum(s for _, s in pauses)
        if errs:
            raise errs[0]
        counts, st = kernels.launch_counts(), B.stats()
        _add_counts(totals, counts)
        check_merges(f"sync cross-doc cycle {c}", counts,
                     st["launches"] + st["batched_fallback"])
        if st["batched_error"] or st["scalar_docs"] or st["demoted_docs"] \
                or st["extract_error"] or st["vectorized_docs"] != SERVE_DOCS:
            raise AssertionError(f"sync cross-doc cycle {c}: {json.dumps(st)}: an error, "
                                 "or an admitted document on the scalar path")
        gens = generations[n_gen:]
        if sum(gens) != SERVE_DOCS or st["launches"] < SERVE_DOCS // SERVE_PER_LAUNCH:
            raise AssertionError(f"sync cross-doc cycle {c}: generations {gens}, "
                                 f"{st['launches']} packed launches")
        launches_a_cycle.append(st["launches"])
        whales.append(st["batched_fallback"])
        gens_a_cycle.append(gens)
        # after every cycle: each server document a merge of its history,
        # its heads its client's
        t0 = time.perf_counter()
        fresh = [DeviceDoc.merge([s], device=device) for s in servers]
        check_serve_equal("sync cross-doc", devs, fresh, c)
        for i in range(SERVE_DOCS):
            if servers[i].get_heads() != clients[i].get_heads():
                raise AssertionError(f"sync cross-doc cycle {c} document {i}: the "
                                     "server's heads are not its client's")
        del fresh
        t_check += time.perf_counter() - t0
    fed = [s.stats["device_feeds"] for s in ss]
    if any(f != {"apply_changes": 0, "apply_batches": 0, "device_feed": SERVE_CYCLES}
           for f in fed):
        raise AssertionError(f"sync cross-doc: feeds by kind {fed[:4]}...: not one "
                             "device_feed a cycle a document")
    if whales[cycle0] < 1:
        raise AssertionError(f"sync cross-doc: whales by cycle {whales}: none in cycle "
                             f"{cycle0}")
    for i, d in enumerate(devs):
        if d.text(W.SERVE_LIVE) != texts[i] or d.text(W.SERVE_ARCHIVE) != "x" * SERVE_BALLAST:
            raise AssertionError(f"sync cross-doc document {i}: live or archive differs "
                                 "from the generator's")
    w = [sum(x[k] - y[k] for x, y in zip(wire, wire_before)) for k in range(4)]
    print(f"sync cross-doc: {SERVE_DOCS} server AutoDocs with resident documents on "
          f"{card}, their clients applying one delta chunk a cycle for {SERVE_CYCLES} "
          f"cycles; frames and bytes client to server {w[0]}, {w[1]}, server to client "
          f"{w[2]}, {w[3]}", flush=True)
    print(f"sync cross-doc: a cycle ({SERVE_DOCS} threads, receive_many into the batcher) p50 "
          f"{statistics.median(seconds):.6f} s max {max(seconds):.6f} s, drain "
          f"{sum(seconds):.6f} s, gc {gcs:.6f} s; packed launches a cycle "
          f"{launches_a_cycle}, whales by cycle {whales}, generations {gens_a_cycle[0]} "
          f"(cycle 0) on {card}", flush=True)
    print(f"sync cross-doc: after every cycle each server's resident document equals "
          f"a DeviceDoc.merge of its history on READ_FETCH ({t_check:.3f} s of merges), "
          f"its heads its client's; live and archive as the generator's", flush=True)
    print(f"sync cross-doc launches {json.dumps({k: v for k, v in totals.items() if v})}",
          flush=True)
    print(f"sync cross-doc: the phase took {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    return {"sync cross-doc": totals}


def sync_paths(card: str, device) -> dict:
    """(l) and (m). Returns the launch counts by path."""
    t0 = time.perf_counter()
    counts = sync_catch_up_paths(card, device)
    print(f"sync catch-up: the phase took {time.perf_counter() - t0:.3f} s", flush=True)
    counts.update(sync_cross_doc_paths(card, device))
    return counts


# -- observability on the card (phases n-q) -------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
OBS_DIR = os.path.join(ROOT, "build", "obs")  # captures, the cost workload
PARENT_TREE = os.path.join(ROOT, "build", "parent")  # joins (q) when unpacked
OBS_COST_BATCHES = 16  # (q): the served drain's first batches a process
# (o): the served drain's first batches, cycled and captured (cut from all
# 64 to keep the smoke inside its budget)
OBS_SERVED_BATCHES = 16
# (q): processes an arm, in turns; one keeps the smoke within its time
# with phase (r) added (two took ~100 s of ~715 s on a slow host)
OBS_COST_ROUNDS = 1


def capture(name: str, fn):
    """``fn()`` under a ``prof`` capture into ``OBS_DIR/name``, inside a
    ``smoke.window`` range, synchronised before the range closes. Returns
    (fn's value, ``prof.read_capture`` of the window)."""
    import shutil

    from automerge_tpu_torch.obs import prof

    d = os.path.join(OBS_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    start = prof.torch_profile_start(d)
    if not start["ok"]:
        raise AssertionError(f"{name}: the capture did not start: {start}")
    try:
        with torch.profiler.record_function("smoke.window"):
            out = fn()
            torch.cuda.synchronize()
    finally:
        stop = prof.torch_profile_stop()
    if not stop["ok"]:
        raise AssertionError(f"{name}: the capture did not stop: {stop}")
    return out, prof.read_capture(stop["trace"], "smoke.window")


def check_ranges(name: str, cap: dict, want: dict) -> None:
    """Each range of ``want`` ({name: least count}) is in the capture
    that often, with CUDA kernels inside it."""
    for r, least in want.items():
        got = cap["ranges"].get(r)
        if got is None or got["count"] < least or got["kernels"] < got["count"]:
            raise AssertionError(f"{name}: range {r} {got}, want {least} or more "
                                 f"with kernels inside: {json.dumps(cap['ranges'])}")
    if not 0 < cap["busy_share"] < 1:
        raise AssertionError(f"{name}: busy share {cap['busy_share']}")


def cycle_summary(reports) -> dict:
    """The cycle reports' aggregate (``prof.summarize_reports``) with the
    per-cycle wall's p50 and max and the attributed fraction's p50."""
    from automerge_tpu_torch.obs import prof

    s = prof.summarize_reports(reports)
    walls = [r["wall_s"] for r in reports]
    return {"cycles": s["cycles"], "wall_p50": statistics.median(walls),
            "wall_max": max(walls), "attributed_frac": s["attributed_frac"],
            "attributed_frac_p50": statistics.median(
                r["attributed_frac"] for r in reports),
            "host_s": s["host_s"], "device_s": s["device_s"],
            "host_pct": s["host_pct"], "device_pct": s["device_pct"],
            "host_share_of_wall": s["host_s"] / s["wall_s"],
            "device_share_of_wall": s["device_s"] / s["wall_s"],
            "overlap_fraction": s["overlap_fraction"], "launches": s["launches"],
            "docs": s["docs"], "occupancy": s["occupancy"],
            "stages_s": {k: v["seconds"] for k, v in s["stages"].items()}}


def print_cap(name: str, cap: dict, card: str) -> None:
    print(f"{name} capture: window {cap['window_s']:.6f} s, {cap['kernels']} kernels, "
          f"device busy {cap['busy_s']:.6f} s, busy share {cap['busy_share']:.7f}; "
          f"ranges {json.dumps(cap['ranges'])} on {card}", flush=True)


def obs_paths(card: str, device) -> None:
    """(n) the text fan-in under a capture, (o) the served drain and (p)
    the cross-document drain under ``prof.cycle``, each drain again under
    a capture."""
    from automerge_tpu_torch import obs
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.obs import prof
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    t_phase = time.perf_counter()
    # (n) one text fan-in
    text = FANINS["text"]
    gc.collect()
    doc, cap = capture("text_fanin", lambda: DeviceDoc.merge(text["blobs"],
                                                             device=device))
    if doc.text(text["text_obj"]) != text["text"]:
        raise AssertionError("obs (n): the captured fan-in's text differs from (a)'s")
    check_ranges("obs (n) text fan-in", cap, {"amtpu.resolve": 1})
    print_cap("obs (n) text fan-in", cap, card)
    del doc

    # (o) the served drain's first OBS_SERVED_BATCHES batches, one cycle a
    # batch, then again under a capture; each against a merge of the base
    # and those batches' changes on the card
    records = FANINS["records"]
    base, reps = records["blobs"][0], records["blobs"][1:]
    batches = W.record_batches(reps, RECORD_BATCH)[:OBS_SERVED_BATCHES]
    drained = DeviceDoc.merge([base] + reps[:OBS_SERVED_BATCHES * RECORD_BATCH],
                              device=device)
    served = DeviceDoc.merge([base], device=device)
    torch.cuda.synchronize()
    gc.collect()
    obs.reset_all()
    prof.profiler.reset()
    reports, inflight = [], None
    with gc_pauses() as pauses:
        for i, b in enumerate(batches):
            # the steps of apply_batches' pipeline on the card: batch k
            # spliced and launched, batch k-1 read back, in one cycle
            with prof.cycle(kind="serve", docs=1) as c:
                _, inflight = served._pipeline_step(b, inflight, None,
                                                    time.perf_counter())
                if i == len(batches) - 1 and inflight is not None:
                    served._collect_async(inflight)
            reports.append(c.report)
    check_serve_equal("obs (o) served, cycled", [served], [drained], -1)
    kl = obs.counter_values("device.kernel_launches", "path")
    so = cycle_summary(reports)
    so["gc_s"] = sum(t for _, t in pauses)
    if so["launches"] != kl.get("per_doc", 0) or so["launches"] < len(batches):
        raise AssertionError(f"obs (o): cycle notes {so['launches']} launches, "
                             f"obs counted {kl}")
    print(f"obs (o) served drain, {len(batches)} batches of {RECORD_BATCH}, one "
          f"prof.cycle a batch: {json.dumps(so)} on {card}", flush=True)
    del served
    gc.collect()
    served = DeviceDoc.merge([base], device=device)
    torch.cuda.synchronize()
    gc.collect()
    _, cap = capture("served_drain", lambda: served.apply_batches(batches))
    check_serve_equal("obs (o) served, captured", [served], [drained], -1)
    check_ranges("obs (o) served drain", cap, {"amtpu.dispatch_async": len(batches)})
    print_cap("obs (o) served drain", cap, card)
    del served, drained

    # (p) the cross-document drain, one cycle a cycle, then under a capture
    doc0, cycle0, n0 = SERVE_BURST
    sbase, deltas, texts = W.serve_workload(
        SERVE_DOCS, SERVE_CYCLES, SERVE_OPS, SERVE_BALLAST, burst={(doc0, cycle0): n0})

    def drain(docs, c):
        B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(docs)],
                          max_docs_per_launch=SERVE_PER_LAUNCH,
                          fallback_ratio=SERVE_FALLBACK, device=device)

    def check_texts(name, docs):
        for i, d in enumerate(docs):
            if d.text(W.SERVE_LIVE) != texts[i] \
                    or d.text(W.SERVE_ARCHIVE) != "x" * SERVE_BALLAST:
                raise AssertionError(f"{name} document {i}: live or archive differs")

    docs = [DeviceDoc.merge([sbase], device=device) for _ in range(SERVE_DOCS)]
    torch.cuda.synchronize()
    prof.profiler.reset()
    B.reset_stats()
    reports, gc_s = [], 0.0
    for c in range(SERVE_CYCLES):
        gc.collect()
        with gc_pauses() as pauses, prof.cycle(kind="cross_doc") as cyc:
            drain(docs, c)
        reports.append(cyc.report)
        gc_s += sum(t for _, t in pauses)
    st = B.stats()
    sp = cycle_summary(reports)
    sp["gc_s"] = gc_s
    if st["batched_error"] or sp["launches"] != st["launches"] + st["batched_fallback"] \
            or sp["docs"] != SERVE_DOCS * SERVE_CYCLES:
        raise AssertionError(f"obs (p): cycle notes {sp}, batched.stats() {st}")
    check_texts("obs (p) cross-doc, cycled", docs)
    print(f"obs (p) cross-doc drain, {SERVE_DOCS} documents x {SERVE_CYCLES} cycles, "
          f"one prof.cycle a cycle: {json.dumps(sp)} on {card}", flush=True)
    docs = [DeviceDoc.merge([sbase], device=device) for _ in range(SERVE_DOCS)]
    torch.cuda.synchronize()
    gc.collect()
    _, cap = capture("cross_doc_drain",
                     lambda: [drain(docs, c) for c in range(SERVE_CYCLES)])
    check_texts("obs (p) cross-doc, captured", docs)
    check_ranges("obs (p) cross-doc drain", cap,
                 {"amtpu.batched_launch": SERVE_CYCLES * SERVE_DOCS // SERVE_PER_LAUNCH})
    print_cap("obs (p) cross-doc drain", cap, card)
    del docs
    gc.collect()

    # the cost phase's workload, for its fresh processes
    import pickle

    os.makedirs(OBS_DIR, exist_ok=True)
    with open(os.path.join(OBS_DIR, "cost_workload.pkl"), "wb") as f:
        pickle.dump({"record": records["blobs"], "record_batch": RECORD_BATCH,
                     "serve": [sbase, deltas], "serve_per_launch": SERVE_PER_LAUNCH,
                     "serve_fallback": SERVE_FALLBACK}, f)
    print(f"obs (n)-(p): the phases took {time.perf_counter() - t_phase:.3f} s",
          flush=True)


def obs_cost_child(tree: str, workload: str) -> int:
    """One process of (q): the served drain's first OBS_COST_BATCHES
    batches and the cross-document drain's SERVE_CYCLES cycles of the
    package under ``tree`` on the card; prints one JSON line."""
    import pickle

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import automerge_tpu_torch
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    if not os.path.abspath(automerge_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {automerge_tpu_torch.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    device = torch.device("cuda", 0)
    with open(workload, "rb") as f:
        wl = pickle.load(f)
    record = wl["record"]
    batches = W.record_batches(record[1:], wl["record_batch"])[:OBS_COST_BATCHES]
    served = DeviceDoc.merge([record[0]], device=device)
    torch.cuda.synchronize()
    gc.collect()
    phases = {}
    served.apply_batches(batches, phases)
    torch.cuda.synchronize()
    base, deltas = wl["serve"]
    docs = [DeviceDoc.merge([base], device=device) for _ in deltas]
    torch.cuda.synchronize()
    cross = []
    for c in range(len(deltas[0])):
        gc.collect()
        t0 = time.perf_counter()
        B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(docs)],
                          max_docs_per_launch=wl["serve_per_launch"],
                          fallback_ratio=wl["serve_fallback"], device=device)
        torch.cuda.synchronize()
        cross.append(time.perf_counter() - t0)
    print(json.dumps({"served_s": phases["batches"], "cross_s": cross}), flush=True)
    return 0


def quartiles(xs) -> list:
    q = statistics.quantiles(xs, n=4)
    return [q[0], q[2]]


def obs_cost(card: str) -> None:
    """(q) what the instruments cost: fresh processes of ``obs_cost_child``
    in turns, OBS_COST_ROUNDS a tree: this tree with spans recorded, this
    tree with ``AUTOMERGE_TPU_SPAN_BUFFER=0``, and, where a parent
    checkout is unpacked under PARENT_TREE, the parent."""
    t_phase = time.perf_counter()
    workload = os.path.join(OBS_DIR, "cost_workload.pkl")
    arms = {"spans": (ROOT, {}), "no spans": (ROOT, {"AUTOMERGE_TPU_SPAN_BUFFER": "0"})}
    if os.path.isdir(os.path.join(PARENT_TREE, "automerge_tpu_torch")):
        arms["parent"] = (PARENT_TREE, {})
    else:
        print(f"obs (q): no parent tree under {PARENT_TREE}: this tree's arms only",
              flush=True)
    names = list(arms)
    runs = {a: [] for a in names}
    for r in range(OBS_COST_ROUNDS):
        for a in (names if r % 2 == 0 else names[::-1]):
            tree, env = arms[a]
            out = subprocess.run(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--obs-cost",
                 tree, workload], env={**os.environ, **env}, capture_output=True,
                text=True, timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"obs (q) {a}: exit {out.returncode}\n"
                                     f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
            runs[a].append(json.loads(out.stdout.strip().splitlines()[-1]))
    for a in names:
        served = [statistics.median(x["served_s"]) for x in runs[a]]
        cross = [statistics.median(x["cross_s"]) for x in runs[a]]
        every_s = [s for x in runs[a] for s in x["served_s"]]
        every_c = [s for x in runs[a] for s in x["cross_s"]]
        print(f"obs (q) {a}: served per batch p50 by process {served} (all "
              f"{len(every_s)} batches: p50 {statistics.median(every_s):.6f} s, "
              f"quartiles {quartiles(every_s)}); cross-doc per cycle p50 by process "
              f"{cross} (all {len(every_c)} cycles: p50 {statistics.median(every_c):.6f}"
              f" s, quartiles {quartiles(every_c)}) on {card}", flush=True)
    print(f"obs (q): {OBS_COST_ROUNDS} processes an arm in turns ({names}); the phase "
          f"took {time.perf_counter() - t_phase:.3f} s", flush=True)


# durable storage (r): the replica changes of (a) left in the journal after
# the compaction, and the follower's cursors
DURABLE_TAIL = 24
DURABLE_CURSORS = (b"smoke-cursor-0", b"smoke-cursor-1")


@contextlib.contextmanager
def timed_calls(targets, seconds: dict, launches: dict = None):
    """Within it, each ``(owner, attribute, label)`` of ``targets`` is
    wrapped to append each call's wall seconds (the card synchronised at
    the end of the call) to ``seconds[label]``; with ``launches``, the
    kernel launches of its calls are added to ``launches[label]``. The
    owners get their attributes back on exit."""
    from automerge_tpu_torch import kernels

    saved = []

    def wrap(fn, label):
        def timed(*a, **kw):
            before = kernels.launch_counts() if launches is not None else None
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                seconds.setdefault(label, []).append(time.perf_counter() - t0)
                if before is not None:
                    after = kernels.launch_counts()
                    got = launches.setdefault(label, dict.fromkeys(after, 0))
                    for k, v in after.items():
                        got[k] += v - before[k]
        return timed

    for owner, attr, label in targets:
        raw = owner.__dict__[attr]
        saved.append((owner, attr, raw))
        if isinstance(raw, classmethod):
            setattr(owner, attr, classmethod(wrap(raw.__func__, label)))
        else:
            setattr(owner, attr, wrap(raw, label))
    try:
        yield
    finally:
        for owner, attr, raw in reversed(saved):
            setattr(owner, attr, raw)


def check_fetch_equal(name: str, dev, want) -> None:
    """``dev`` equals ``want`` on the six READ_FETCH arrays."""
    import numpy as np

    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    if (dev.log.n, dev.log.n_objs) != (want.log.n, want.log.n_objs):
        raise AssertionError(f"{name}: {dev.log.n} rows, {dev.log.n_objs} objects; "
                             f"the fan-in's {want.log.n}, {want.log.n_objs}")
    for k in DeviceDoc.READ_FETCH:
        cut = dev.log.n_objs + 2 if k.startswith("obj_") else dev.log.n
        if not np.array_equal(np.asarray(dev.res[k])[:cut], np.asarray(want.res[k])[:cut]):
            raise AssertionError(f"{name}: {k} differs from the fan-in's")


class DurableOps:
    """The store's transitions over durable documents under one
    directory, as a serving layer supplies them (``store/docstore.py``):
    a cold open without a mirror, a close that compacts when asked, and
    the mirror's drop and build; the open documents in ``docs``."""

    def __init__(self, root: str, device):
        self.root, self.device, self.docs = root, device, {}

    def open_cold(self, name):
        from automerge_tpu_torch.api import AutoDoc

        ref = self.docs[name]
        dd = AutoDoc.open(os.path.join(self.root, name), fsync=ref.fsync_policy,
                          text_encoding=ref.text_encoding, device=self.device)
        self.docs[name] = dd
        return dd

    def close_cold(self, name, compact):
        from automerge_tpu_torch.store import ColdDocRef

        dd = self.docs[name]
        with dd.lock:
            if compact and not dd.degraded:
                dd.compact()
            dd.close()
            acked, appended = dd.acked_prefix()
            ref = ColdDocRef(name, fsync_policy=dd.journal.fsync_policy,
                             text_encoding=dd._core.text_encoding, acked=acked,
                             appended=appended,
                             replication_cursor=dd.replication_cursor)
        self.docs[name] = ref
        return ref

    def drop_device(self, name):
        dd = self.docs[name]
        with dd.lock:
            dd.drop_device_mirror()

    def build_device(self, name):
        self.docs[name].build_device_mirror()
        return True


def durable_paths(card: str, device) -> dict:
    """(r) durable storage on (a)'s text fan-in (see the module
    docstring). Returns the launch counts by path."""
    import shutil
    import tempfile

    from automerge_tpu_torch import kernels, obs
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.core.document import Document
    from automerge_tpu_torch.integrity import DigestState, finalize_digest
    from automerge_tpu_torch.ops.batched import CrossDocBatcher
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.storage import durable as D
    from automerge_tpu_torch.storage import journal as J
    from automerge_tpu_torch.storage import runsnap as R
    from automerge_tpu_torch.storage.change import parse_change
    from automerge_tpu_torch.store import DocStore, StoreBudgets

    t_phase = time.perf_counter()
    held = FANINS["text"]
    fan, text_obj, text = held["doc"], held["text_obj"], held["text"]
    parsed = [parse_change(b)[0] for b in held["blobs"]]
    head, tail = parsed[:-DURABLE_TAIL], parsed[-DURABLE_TAIL:]
    want = DigestState()
    want.recompute(c.hash for c in parsed)
    want_digest = finalize_digest(*want.value(), fan.current_heads())
    root = tempfile.mkdtemp(prefix="amtpu-durable-")
    path = os.path.join(root, "text")
    counts, seconds = {}, {}

    def read_back(name, dd, dev):
        if sorted(dd.get_heads()) != sorted(fan.current_heads()):
            raise AssertionError(f"durable {name}: heads differ from the fan-in's")
        if dd.doc_digest() != {"digest": want_digest, "changes": len(parsed)}:
            raise AssertionError(f"durable {name}: doc_digest differs from the fan-in's")
        check_fetch_equal(f"durable {name}", dev, fan)
        if dev.text(text_obj) != text:
            raise AssertionError(f"durable {name}: the mirror's text differs")
        bad = dev.audit_columns()
        if bad:
            raise AssertionError(f"durable {name}: audit_columns() == {bad}")

    try:
        # write: the fan-in's changes journaled, fed to the mirror and
        # compacted into an image of the mirror's log; a tail journaled
        kernels.reset_launches()
        t0 = time.perf_counter()
        dd = AutoDoc.open(path, mirror=True, fsync="always", device=device)
        dd.apply_changes(head)
        t1 = time.perf_counter()
        dd.device_doc.apply_changes(head)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts["durable write mirror"] = kernels.launch_counts()
        check_launches("durable write mirror", counts["durable write mirror"],
                       RUN_NATIVE, TRANSPORT_ONLY)
        obs.reset_all()
        if not dd.compact() or obs.counter_values("compact.image_rebuild", "") != {}:
            raise AssertionError("durable write: the compaction did not take the "
                                 "mirror's log")
        t3 = time.perf_counter()
        dd.apply_changes(tail)
        dd.close()
        t4 = time.perf_counter()
        snap = open(os.path.join(path, D.SNAPSHOT_NAME), "rb").read()
        jbytes = open(os.path.join(path, D.JOURNAL_NAME), "rb").read()
        if not R.is_runsnap(snap):
            raise AssertionError("durable write: the snapshot is not an ARSN image")
        records = [(r.rec_type, r.payload) for r in J.scan_records(jbytes)[0]]
        if len(records) != DURABLE_TAIL:
            raise AssertionError(f"durable write: {len(records)} journal records, "
                                 f"not the tail's {DURABLE_TAIL}")
        print(f"durable (r) write: {len(head)} changes journaled in {t1 - t0:.6f} s "
              f"(fsync=always, one fsync an ack), the mirror fed in {t2 - t1:.6f} s, "
              f"compact (ARSN from the mirror's log, {len(snap)} bytes) "
              f"{t3 - t2:.6f} s, {DURABLE_TAIL} tail changes journaled "
              f"({len(jbytes)} bytes) and closed {t4 - t3:.6f} s on {card}",
              flush=True)

        # reopen cold with a mirror on the card, each step timed
        class TimedFS(J.OsFS):
            def read_bytes(self, p):
                t = time.perf_counter()
                try:
                    return super().read_bytes(p)
                finally:
                    seconds.setdefault("read " + os.path.basename(p), []).append(
                        time.perf_counter() - t)

        launches = {}
        targets = [(R, "parse", "parse"), (R.RunImage, "to_oplog", "to_oplog"),
                   (J.Journal, "open", "journal scan"),
                   (Document, "apply_changes", "document apply"),
                   (DeviceDoc, "resolve", "resolve"),
                   (DeviceDoc, "apply_changes", "replay feed")]
        obs.reset_all()
        gc.collect()
        with gc_pauses() as pauses, timed_calls(targets, seconds, launches):
            t0 = time.perf_counter()
            dd = AutoDoc.open(path, mirror=True, fsync="always", device=device,
                              fs=TimedFS())
            t1 = time.perf_counter()
            mirror_text = dd.device_doc.text(text_obj)
            t2 = time.perf_counter()
            kernels.reset_launches()
            doc_text = dd.text(text_obj)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        counts["durable first read"] = kernels.launch_counts()
        gc_s = sum(s for _, s in pauses)
        counts["durable open resolve"] = launches["resolve"]
        counts["durable replay"] = launches["replay feed"]
        if not {"read snapshot.am", "read journal.waj"} <= set(seconds):
            raise AssertionError(f"durable open: the reads from disk were not "
                                 f"timed: {sorted(seconds)}")
        if launches["resolve"] != held["counts"]:
            raise AssertionError(
                f"durable open: the resolve launched {json.dumps(launches['resolve'])},"
                f" the fan-in merge {json.dumps(held['counts'])}")
        check_launches("durable replay", launches["replay feed"], RUN_NATIVE,
                       TRANSPORT_ONLY)
        check_launches("durable first read", counts["durable first read"], RUN_NATIVE,
                       TRANSPORT_ONLY)
        if mirror_text != text or doc_text != text:
            raise AssertionError("durable open: the read differs from the fan-in's")
        read_back("open", dd, dd.device_doc)
        replayed = obs.counter_values("journal.replayed_records", "")
        reencode = obs.counter_values("oplog.hydrate_reencode", "")
        if replayed != {"": DURABLE_TAIL} or reencode:
            raise AssertionError(f"durable open: replayed {replayed}, re-encoded "
                                 f"{reencode}")
        steps = {k: [round(x, 6) for x in v] for k, v in seconds.items()}
        print(f"durable (r) open (warm page cache): {t1 - t0:.6f} s to an open "
              f"document with its mirror; by step (a list: one entry a call; "
              f"document apply: the image's changes, then the journal's) "
              + json.dumps(steps)
              + f"; the mirror's first read {t2 - t1:.6f} s, the document's first "
              f"read (its stale read: one merge) {t3 - t2:.6f} s; gc {gc_s:.6f} s "
              f"in the window; hydrate_bytes "
              + json.dumps(obs.counter_values("store.hydrate_bytes", "codec"))
              + f" on {card}", flush=True)
        print("durable (r) open: heads, doc_digest, the read and the six READ_FETCH "
              "arrays equal the fan-in's; audit_columns() == []; the resolve's "
              "launches the fan-in merge's " + json.dumps(launches["resolve"])
              + "; the replay's feed " + json.dumps(
                  {k: v for k, v in launches["replay feed"].items() if v})
              + "; the first read " + json.dumps(
                  {k: v for k, v in counts["durable first read"].items() if v}),
              flush=True)

        # through the store: hot, warm, cold, then hot again
        ops = DurableOps(root, device)
        ops.docs["text"] = dd
        store = DocStore(ops, StoreBudgets(evict_interval_s=0.0))
        store.admit("text", dd, mirror=True)
        tiers = [store.tier("text")]
        t0 = time.perf_counter()
        store.demote("text", "warm")
        tiers.append(store.tier("text"))
        t1 = time.perf_counter()
        store.demote("text", "cold")
        tiers.append(store.tier("text"))
        t2 = time.perf_counter()
        warm = store.ensure_open("text")
        tiers.append(store.tier("text"))
        t3 = time.perf_counter()
        obs.reset_all()
        kernels.reset_launches()
        gc.collect()
        with gc_pauses() as pauses:
            t4 = time.perf_counter()
            store.touch("text")
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        tiers.append(store.tier("text"))
        counts["durable promote"] = kernels.launch_counts()
        if tiers != ["hot", "warm", "cold", "warm", "hot"]:
            raise AssertionError(f"durable store: tiers {tiers}")
        check_launches("durable promote", counts["durable promote"],
                       held["must"], TRANSPORT_ONLY)
        promote_bytes = obs.counter_values("store.promote_resident_bytes", "")
        if obs.counter_values("oplog.hydrate_reencode", "") or not promote_bytes:
            raise AssertionError("durable store: the promotion re-encoded or "
                                 "counted no resident bytes")
        leader = warm
        read_back("store round trip", leader, leader.device_doc)
        if leader.text(text_obj) != text:
            raise AssertionError("durable store: the read differs from the fan-in's")
        print(f"durable (r) store: tiers {tiers}; hot->warm {t1 - t0:.6f} s, "
              f"warm->cold {t2 - t1:.6f} s, cold->warm (hydrate) {t3 - t2:.6f} s, "
              f"warm->hot (promote from the retained image) {t5 - t4:.6f} s "
              f"(gc {sum(s for _, s in pauses):.6f} s), store.promote_resident_bytes "
              f"{promote_bytes['']}; the read and READ_FETCH the fan-in's; promote "
              "launches " + json.dumps(
                  {k: v for k, v in counts["durable promote"].items() if v})
              + f" on {card}", flush=True)

        # a replicated apply: the written image, then the journal's tail
        fol = AutoDoc.open(os.path.join(root, "follower"), mirror=True,
                           fsync="always", device=device)
        t0 = time.perf_counter()
        fol.apply_replicated_snapshot(snap, DURABLE_CURSORS[0])
        fol.drop_device_mirror()
        fol.build_device_mirror()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batcher = CrossDocBatcher(mode="1", device=device)
        fed = []
        kernels.reset_launches()
        t2 = time.perf_counter()
        n = fol.apply_replicated(records, DURABLE_CURSORS[1], device_feed=lambda doc, dev, chs:
                                 fed.append(batcher.apply(dev, [chs])))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts["durable follower feed"] = kernels.launch_counts()
        if n != DURABLE_TAIL or fed != [DURABLE_TAIL]:
            raise AssertionError(f"durable follower: applied {n}, fed {fed}")
        check_launches("durable follower feed", counts["durable follower feed"],
                       RUN_NATIVE, TRANSPORT_ONLY)
        if fol.replication_cursor != DURABLE_CURSORS[1]:
            raise AssertionError("durable follower: the cursor was not persisted")
        check_fetch_equal("durable follower", fol.device_doc, leader.device_doc)
        read_back("follower", fol, fol.device_doc)
        print(f"durable (r) follower: snapshot catch-up and promotion "
              f"{t1 - t0:.6f} s, apply_replicated of {n} records with the feed "
              f"through a CrossDocBatcher {t3 - t2:.6f} s; the mirror equals the "
              "leader's; feed launches " + json.dumps(
                  {k: v for k, v in counts["durable follower feed"].items() if v})
              + f" on {card}", flush=True)
        fol.close()
        store.close()
        leader.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"durable (r): the phase took {time.perf_counter() - t_phase:.3f} s on {card}",
          flush=True)
    return counts


# -- the serving layer on the card (phase s) ------------------------------------

SRPC_DOCS = 32  # mirrored durable documents, one peer thread each
SRPC_ROUNDS = 16  # sync rounds after the base's, one delta chunk a round
SRPC_WORKERS = 8  # the server's shard workers
SRPC_CAPTURE_ROUND = 8  # the round under a profileStart / profileStop capture
SRPC_ACTOR = 0xC0  # the peers' actors 0xc0..


def load_client():
    """``clients/python/amtpu_client.py``, which imports neither package."""
    import importlib.util

    path = os.path.join(ROOT, "clients", "python", "amtpu_client.py")
    spec = importlib.util.spec_from_file_location("amtpu_client", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wire_json(x):
    """A value as the JSON-RPC wire carries it (``materialize``'s form)."""
    import base64

    return json.loads(json.dumps(x, default=lambda v: {
        "$bytes": base64.b64encode(bytes(v)).decode("ascii")}))


def serve_in_process(card: str, device, root: str) -> tuple:
    """(s), in process: see the module docstring. Returns (launch counts
    by path, the first packed super-batch's spec)."""
    import base64
    import threading

    import numpy as np

    from automerge_tpu_torch import kernels, obs
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.obs import prof
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import merge_columns
    from automerge_tpu_torch.ops.oplog import pad_columns
    from automerge_tpu_torch.serve import SocketRpcServer
    from automerge_tpu_torch.storage.change import parse_change
    from automerge_tpu_torch.sync import SyncSession
    from automerge_tpu_torch.types import ActorId

    amtpu = load_client()
    base, deltas, texts = W.serve_workload(SRPC_DOCS, SRPC_ROUNDS, SERVE_OPS,
                                           SERVE_BALLAST)
    base_ch = parse_change(base)[0]
    peers = []
    for i in range(SRPC_DOCS):
        d = AutoDoc(ActorId(bytes([SRPC_ACTOR, i]) * 8), device="cpu")
        d.apply_changes([base_ch])
        peers.append(d)
    srv = SocketRpcServer(host="127.0.0.1", port=0,
                          durable_dir=os.path.join(root, "served"),
                          workers=SRPC_WORKERS)
    if srv.rpc.device.type != "cuda" or srv.batcher.device.type != "cuda":
        raise AssertionError(f"served rpc: the server is on {srv.rpc.device}, its "
                             f"batcher on {srv.batcher.device}")
    flushes, captured = [], []
    raw_flush = srv.batcher._flush

    def timed_flush(gen):
        t = time.perf_counter()
        try:
            raw_flush(gen)
        finally:
            flushes.append((time.perf_counter() - t, len(gen.subs) + len(gen.stages)))

    srv.batcher._flush = timed_flush
    dispatch = B._dispatch_packed

    def noting_dispatch(cols, n_objs, n_props, *a, **k):
        if not captured:
            captured.append((pad_columns(cols, n_objs), n_objs, n_props))
        return dispatch(cols, n_objs, n_props, *a, **k)

    B._dispatch_packed = noting_dispatch
    # the GIL switch interval a server process runs with (rpc.main)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(float(
        os.environ.get("AUTOMERGE_TPU_SERVE_SWITCH_INTERVAL", "0.001")))
    srv.start()
    address = "%s:%d" % tuple(srv.address)
    counts = {}
    try:
        ctl = amtpu.RetryingClient(address, deadline_s=120, timeout_s=120)
        ctl.call("configure", syncTimeoutMs=600_000)
        obs.reset_all()
        B.reset_stats()
        kernels.reset_launches()
        t_open = time.perf_counter()
        handles = [ctl.call("openDurable", name=f"s{i}", device=True)["doc"]
                   for i in range(SRPC_DOCS)]
        sessions = [ctl.call("syncSessionNew", doc=h, epoch=2)["session"]
                    for h in handles]
        t_open = time.perf_counter() - t_open
        psess = [SyncSession(p, epoch=1) for p in peers]
        clients = [amtpu.RetryingClient(address, deadline_s=120, timeout_s=120)
                   for _ in range(SRPC_DOCS)]
        rtts, round_s, wire = [], [], [0, 0]
        lock = threading.Lock()

        def converse(i, r):
            c, ps, ss = clients[i], psess[i], sessions[i]
            now = 1000.0 * (r + 1)
            for k in range(40):
                frame = ps.poll(now + k)
                if frame is not None:
                    t = time.perf_counter()
                    c.call("syncSessionReceive", session=ss,
                           data=base64.b64encode(frame).decode("ascii"))
                    with lock:
                        rtts.append(time.perf_counter() - t)
                        wire[0] += len(frame)
                back = c.call("syncSessionPoll", session=ss)
                if back is not None:
                    raw = base64.b64decode(back)
                    with lock:
                        wire[1] += len(raw)
                    ps.receive(raw, now + k)
                if (frame is None and back is None and ps.converged()
                        and c.call("syncSessionStats", session=ss)["converged"]):
                    return
            raise AssertionError(f"served rpc round {r} document {i}: the sessions "
                                 "did not converge")

        def one_round(r):
            errs = []

            def worker(i):
                try:
                    if r:
                        peers[i].apply_changes([parse_change(deltas[i][r - 1])[0]])
                    converse(i, r)
                except BaseException as e:  # noqa: BLE001 - raised below
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(SRPC_DOCS)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if errs:
                raise errs[0]

        cap = None
        gc.collect()
        for r in range(SRPC_ROUNDS + 1):
            if r != SRPC_CAPTURE_ROUND:
                one_round(r)
                continue
            d = os.path.join(OBS_DIR, "served_rpc")
            start = ctl.call("profileStart", dir=d)
            if not start["ok"]:
                raise AssertionError(f"served rpc: profileStart answered {start}")
            try:
                one_round(r)
            finally:
                stop = ctl.call("profileStop")
            if not stop["ok"]:
                raise AssertionError(f"served rpc: profileStop answered {stop}")
            # the capture holds the round and two requests around it: every
            # kernel in it ran in the round, whose wall is the denominator
            cap = prof.read_capture(stop["trace"])
            cap["round_s"] = round_s[-1]
            cap["busy_share"] = cap["busy_s"] / round_s[-1]
        counts["served rpc"] = kernels.launch_counts()
        stats = B.stats()
        by_path = obs.counter_values("device.kernel_launches", "path")
        check_launches("served rpc", counts["served rpc"],
                       RUN_NATIVE + ("scatter_winners",), TRANSPORT_ONLY)
        if stats["launches"] < 1 or by_path.get("batched", 0) != stats["launches"] \
                or stats["batched_error"]:
            raise AssertionError(f"served rpc: batcher {json.dumps(stats)}, launches by "
                                 f"path {json.dumps(by_path)}: no packed launch, or an "
                                 "error")
        # the packed launches ran on the batcher's leader threads, the
        # capture started on a connection thread: their ranges are in it
        check_ranges("served rpc capture", cap, {"amtpu.batched_launch": 1})
        shed = obs.counter_values("serve.shed", "class")
        errors = obs.counter_values("rpc.errors", "type")
        if errors:
            raise AssertionError(f"served rpc: error answers {json.dumps(errors)}")

        # every mirror a fresh resolve on the card of its document's save(),
        # every document's materialize its peer's
        t0 = time.perf_counter()
        for i, h in enumerate(handles):
            saved = base64.b64decode(ctl.call("save", doc=h))
            fresh = DeviceDoc.merge([AutoDoc.load(saved, device="cpu")], device=device)
            mirror = srv.rpc._docs[h].device_doc
            if mirror is None or mirror.device.type != "cuda":
                raise AssertionError(f"served rpc document {i}: no mirror on the card")
            check_fetch_equal(f"served rpc document {i}", mirror, fresh)
            if mirror.text(W.SERVE_LIVE) != texts[i]:
                raise AssertionError(f"served rpc document {i}: live differs from the "
                                     "generator's")
            if ctl.call("materialize", doc=h) != wire_json(peers[i].hydrate()):
                raise AssertionError(f"served rpc document {i}: materialize differs "
                                     "from its peer's document")
        t_check = time.perf_counter() - t0
        # no CUDA error left behind by the server's threads: a device-wide
        # synchronize raises a pending one, and this thread still launches
        torch.cuda.synchronize()
        if int((torch.ones(4, device=device) * 2).sum()) != 8:
            raise AssertionError("served rpc: a launch after the rounds went wrong")
        # captured: the first packed super-batch, against the plain CPU merge
        (cols, n_objs, n_props) = captured[0]
        plain = merge_columns(dict(cols), fetch=DeviceDoc.READ_FETCH, n_objs=n_objs,
                              n_props=n_props, device="cpu")
        card_res = merge_columns(dict(cols), fetch=DeviceDoc.READ_FETCH, n_objs=n_objs,
                                 n_props=n_props, device=device)
        for k in DeviceDoc.READ_FETCH:
            if not np.array_equal(np.asarray(card_res[k]), np.asarray(plain[k])):
                raise AssertionError(f"served rpc packed launch: {k} differs from the "
                                     "plain CPU merge")

        # the store: document 0 to warm and cold, a request that hydrates it
        # (docDigest by name), one that promotes it (materialize)
        name, h0 = "s0", handles[0]
        before = srv.rpc._docs[h0].device_doc
        tiers = [ctl.call("storeDemote", name=name, to="warm")["tier"],
                 ctl.call("storeDemote", name=name, to="cold")["tier"]]
        t0 = time.perf_counter()
        ctl.call("docDigest", name=name)
        t_hydrate = time.perf_counter() - t0
        tiers.append(srv.rpc.store.tier(name))
        kernels.reset_launches()
        t0 = time.perf_counter()
        ctl.call("materialize", doc=h0)
        torch.cuda.synchronize()
        t_promote = time.perf_counter() - t0
        tiers.append(srv.rpc.store.tier(name))
        counts["served rpc promote"] = kernels.launch_counts()
        if tiers != ["warm", "cold", "warm", "hot"]:
            raise AssertionError(f"served rpc store: tiers {tiers}")
        check_launches("served rpc promote", counts["served rpc promote"],
                       RUN_NATIVE + ("scatter_winners",), TRANSPORT_ONLY)
        after = srv.rpc._docs[h0].device_doc
        if after is before or after is None:
            raise AssertionError("served rpc store: the promotion kept the old mirror")
        check_fetch_equal("served rpc store round trip", after, before)

        rt = {"p50": statistics.median(rtts), "p95": statistics.quantiles(rtts, n=20)[18]}
        fl = [f for f, _ in flushes]
        print(f"served rpc (s): {SRPC_DOCS} durable documents opened with "
              f"{{\"device\": true}} in {t_open:.6f} s, their sessions fed by "
              f"{SRPC_DOCS} peer threads over TCP (clients/python/amtpu_client.py): "
              f"the base round (each mirror's first feed) {round_s[0]:.6f} s, then "
              f"{SRPC_ROUNDS} delta rounds, p50 {statistics.median(round_s[1:]):.6f} s "
              f"max {max(round_s[1:]):.6f} s; "
              f"syncSessionReceive round trip p50 {rt['p50']:.6f} s p95 "
              f"{rt['p95']:.6f} s over {len(rtts)} calls (switch interval "
              f"{sys.getswitchinterval()} s, as a server process); bytes peer to "
              f"server {wire[0]}, server to peer {wire[1]} on {card}", flush=True)
        print(f"served rpc (s): the batcher's drain cycles {len(fl)}, p50 "
              f"{statistics.median(fl):.6f} s max {max(fl):.6f} s, documents a cycle "
              f"p50 {statistics.median(n for _, n in flushes)} max "
              f"{max(n for _, n in flushes)}; packed launches {stats['launches']}, "
              f"whales {stats['batched_fallback']}, useful rows "
              f"{stats['useful_rows']} padded {stats['padded_rows']}; shed "
              f"{json.dumps(shed)} on {card}", flush=True)
        print(f"served rpc (s) capture of round {SRPC_CAPTURE_ROUND} (profileStart / "
              f"profileStop over the RPC): the round {cap['round_s']:.6f} s (the "
              f"trace's span {cap['window_s']:.6f} s), {cap['kernels']} kernels, device "
              f"busy {cap['busy_s']:.6f} s, busy share of the round "
              f"{cap['busy_share']:.7f}; ranges {json.dumps(cap['ranges'])} on {card}",
              flush=True)
        print(f"served rpc (s): every mirror equals a fresh resolve on the card of its "
              f"document's save() on READ_FETCH, every materialize its peer's "
              f"({t_check:.3f} s of checks); no CUDA error pending after the "
              f"server's threads; the first packed super-batch (P "
              f"{len(cols['action'])}) equals the plain CPU merge; launches "
              + json.dumps({k: v for k, v in counts["served rpc"].items() if v}),
              flush=True)
        print(f"served rpc (s) store: tiers {tiers}; the hydrating request "
              f"(docDigest) {t_hydrate:.6f} s, the promoting request (materialize) "
              f"{t_promote:.6f} s, the mirror equal to the one before on READ_FETCH; "
              "promote launches " + json.dumps(
                  {k: v for k, v in counts["served rpc promote"].items() if v})
              + f" on {card}", flush=True)
        for c in clients + [ctl]:
            c.close()
    finally:
        B._dispatch_packed = dispatch
        srv.stop()
        sys.setswitchinterval(switch)
    return counts, captured[0]


def serve_process(card: str, root: str) -> None:
    """(s), a fresh process: ``python -m automerge_tpu_torch.rpc --socket
    127.0.0.1:0 --durable DIR`` on the card (see the module docstring)."""
    import ast
    import base64
    import threading

    amtpu = load_client()
    held = FANINS["text"]
    data = base64.b64encode(b"".join(held["blobs"])).decode("ascii")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "automerge_tpu_torch.rpc", "--socket", "127.0.0.1:0",
         "--durable", os.path.join(root, "process")],
        cwd=ROOT, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    err_lines = []
    try:
        address = None
        for line in proc.stderr:
            err_lines.append(line)
            if line.startswith("serving on "):
                address = "%s:%d" % ast.literal_eval(line[len("serving on "):].strip())
                break
        if address is None:
            raise AssertionError("served rpc process: no 'serving on' line: "
                                 + "".join(err_lines)[-2000:])
        drain = threading.Thread(target=lambda: err_lines.extend(proc.stderr),
                                 daemon=True)
        drain.start()
        c = amtpu.RetryingClient(address, deadline_s=300, timeout_s=300)
        h = c.call("openDurable", name="text", device=True)["doc"]
        t_first = time.perf_counter() - t0
        t1 = time.perf_counter()
        c.call("applyChanges", doc=h, data=data)
        t2 = time.perf_counter()
        text = c.call("text", doc=h, obj=held["text_obj"])
        t3 = time.perf_counter()
        snap = c.call("metrics", format="json")["metrics"]
        launches = sum(e["value"] for e in snap if e["type"] == "counter"
                       and e["name"] == "device.kernel_launches")
        if text != held["text"]:
            raise AssertionError("served rpc process: the text differs from (a)'s")
        if not launches > 0:
            raise AssertionError("served rpc process: metrics count no kernel launch")
        if c.call("shutdown") is not None:
            raise AssertionError("served rpc process: shutdown answered a value")
        c.close()
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"served rpc process: exit code {rc}: "
                                 + "".join(err_lines)[-2000:])
        print(f"served rpc (s) process: spawn to the first answer {t_first:.6f} s, "
              f"applyChanges of (a)'s {len(held['blobs'])} chunks ({len(data)} base64 "
              f"bytes) {t2 - t1:.6f} s, the text read (one merge) {t3 - t2:.6f} s, "
              f"equal to (a)'s; device.kernel_launches in metrics {launches}; "
              f"shutdown, exit 0 on {card}", flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def serve_paths(card: str, device) -> tuple:
    """(s) the serving layer: a socket server in process, then a fresh
    server process. Returns (launch counts by path, the spec of one packed
    super-batch of the served documents)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="amtpu-serve-")
    try:
        counts, spec = serve_in_process(card, device, root)
        serve_process(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"served rpc (s): the phase took {time.perf_counter() - t_phase:.3f} s "
          f"on {card}", flush=True)
    return counts, spec


CLUSTER_DOCS = 32  # (t): serve-shaped documents, cut from SERVE_DOCS = 128
CLUSTER_ROUNDS = 16  # delta rounds after the base
CLUSTER_FAILOVER_ROUND = 8  # L0 stops after this round
CLUSTER_CAPTURE_ROUND = 4  # the round under a prof capture
CLUSTER_WORKERS = 4  # each node's shard workers
CLUSTER_CLIENTS = 8  # client threads writing through the router
CLUSTER_FANIN_PARTS = 8  # applyChanges requests carrying (a)'s chunks
CLUSTER_HEARTBEAT = 0.25  # the router's liveness poll, seconds
CLUSTER_ACTOR = 0xD0  # the sync peers' actors 0xd0.. after the failover
CLUSTER_STREAM = "smoke/pipelined"  # the pipelined shipper's stream id


def cluster_drains(f0, f2, drains: list):
    """Note every follower drain of ``f0`` and ``f2`` in ``drains``: the
    node, its seconds (synchronised), the documents it fed, its packed
    launches (``resolve_stages``' documents packed and peeled) and its
    kernels' launches (no other launch runs beside a drain until the
    failover). Returns a function that restores ``resolve_stages``."""
    import threading

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops import batched as B

    raw_resolve = B.resolve_stages
    local = threading.local()

    def noting_resolve(stages, *a, **k):
        out = raw_resolve(stages, *a, **k)
        noted = getattr(local, "launches", None)
        if noted is not None:  # a follower drain's, not a batcher's
            noted.append(out)
        return out

    def wrap(node, label):
        raw = node._feed_repl_mirrors

        def noted(feeds):
            local.launches = []
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            try:
                return raw(feeds)
            finally:
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                drains.append({"node": label, "s": time.perf_counter() - t0,
                               "docs": len({id(f[1]) for f in feeds}),
                               "launches": local.launches,
                               "kernels": {k: v - before[k] for k, v in after.items()}})
                local.launches = None
        node._feed_repl_mirrors = noted

    B.resolve_stages = noting_resolve
    wrap(f0, "F0")
    wrap(f2, "F2")

    def restore():
        B.resolve_stages = raw_resolve
    return restore


def cluster_in_process(card: str, device, root: str) -> dict:
    """(t), see the module docstring. Returns the launch counts by path."""
    import base64
    import socket
    import threading

    from automerge_tpu_torch import kernels, obs
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.cluster import ClusterNode, ClusterRouter, HashRing
    from automerge_tpu_torch.cluster.replication import encode_batch, encode_cursor
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.storage.change import parse_change
    from automerge_tpu_torch.sync import SyncSession
    from automerge_tpu_torch.types import ActorId

    amtpu = load_client()
    held = FANINS["text"]
    base, deltas, texts = W.serve_workload(CLUSTER_DOCS, CLUSTER_ROUNDS, SERVE_OPS,
                                           SERVE_BALLAST)
    base_ch = parse_change(base)[0]
    ring = HashRing([0, 1])
    names = [f"c{i}" for i in range(CLUSTER_DOCS)]
    fan = next(f"fanin{k}" for k in range(1000) if ring.member_for(f"fanin{k}") == 0)
    group0 = [i for i, n in enumerate(names) if ring.member_for(n) == 0]
    # each document's model at every round: what the router must read back
    models = []
    for i in range(CLUSTER_DOCS):
        d = AutoDoc(ActorId(bytes([CLUSTER_ACTOR, i]) * 8), device="cpu")
        d.apply_changes([base_ch])
        models.append(d)

    def node(name, **kw):
        n = ClusterNode(node_id=name, host="127.0.0.1", port=0,
                        durable_dir=os.path.join(root, name), workers=CLUSTER_WORKERS,
                        **kw)
        n.start()
        return n

    def addr(n):
        return "%s:%d" % tuple(n.address)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(float(
        os.environ.get("AUTOMERGE_TPU_SERVE_SWITCH_INTERVAL", "0.001")))
    nodes, router = [], None
    counts, drains = {}, []
    restore = None
    try:
        # a promoted F0 has no follower of its own: it acks on its own disk
        f0 = node("F0", role="follower", ack_replicas=0)
        nodes.append(f0)
        l0 = node("L0", role="leader", replicate_to=[addr(f0)], ack_replicas=1)
        nodes.append(l0)
        l1 = node("L1", role="leader")
        nodes.append(l1)
        f2 = node("F2", role="follower", ack_replicas=0)
        nodes.append(f2)
        for n in nodes:
            if n.rpc.device.type != "cuda" or n.batcher.device.type != "cuda":
                raise AssertionError(f"cluster: node {n.rpc.node_id} on {n.rpc.device}, "
                                     f"its batcher on {n.batcher.device}")
        router = ClusterRouter([[addr(l0), addr(f0)], [addr(l1)]],
                               heartbeat=CLUSTER_HEARTBEAT, miss_limit=3)
        router.start()
        raddr = "%s:%d" % tuple(router.address)
        print(f"cluster (t) layout: group 0 = leader L0 {addr(l0)} (ack_replicas=1) + "
              f"follower F0 {addr(f0)}, group 1 = leader L1 {addr(l1)}, router "
              f"{raddr} (heartbeat {CLUSTER_HEARTBEAT} s, 3 misses); a spare follower "
              f"F2 {addr(f2)} for the pipelined drain; {CLUSTER_WORKERS} workers a node; "
              f"every node and batcher on {f0.rpc.device}; the fan-in '{fan}' and "
              f"{len(group0)} of {CLUSTER_DOCS} serve documents placed on group 0",
              flush=True)
        # F0's mirrors, opened before the first write
        fc = amtpu.RetryingClient(addr(f0), deadline_s=300, timeout_s=300)
        for name in [fan] + [names[i] for i in group0]:
            fc.call("openDurable", name=name, device=True)
        fc.close()
        obs.reset_all()
        B.reset_stats()
        kernels.reset_launches()
        restore = cluster_drains(f0, f2, drains)
        t_phase0 = time.perf_counter()

        # (a)'s fan-in in CLUSTER_FANIN_PARTS applyChanges requests
        ctl = amtpu.RetryingClient(raddr, deadline_s=600, timeout_s=600)
        fh = ctl.call("openDurable", name=fan)["doc"]
        blobs = held["blobs"]
        cut = [round(k * len(blobs) / CLUSTER_FANIN_PARTS)
               for k in range(CLUSTER_FANIN_PARTS + 1)]
        t0 = time.perf_counter()
        fan_acks = []
        for k in range(CLUSTER_FANIN_PARTS):
            part = b"".join(blobs[cut[k]:cut[k + 1]])
            ctl.call("applyChanges", doc=fh,
                     data=base64.b64encode(part).decode("ascii"))
            fan_acks.append(time.perf_counter() - t0)
        # ack_replicas=1: the last ack came after F0's drain of the last part
        fdoc = f0.rpc._docs[f0.rpc._durable_names[fan]]
        lsn = l0.rpc.hub.lsn(fan)
        got = f0.rpc.clusterStatus({})["docs"][fan]["cursor"]
        if got is None or got["lsn"] != lsn:
            raise AssertionError(f"cluster: F0's fan-in cursor {got}, L0's LSN {lsn}")
        t1 = time.perf_counter()
        with fdoc.lock:
            fan_text = fdoc.device_doc.text(held["text_obj"])
        t_first_read = time.perf_counter() - t1
        if fan_text != held["text"]:
            raise AssertionError("cluster: the fan-in's mirror on F0 differs from (a)'s")
        print(f"cluster (t) fan-in: {len(blobs)} chunks in {CLUSTER_FANIN_PARTS} "
              f"quorum-acked applyChanges through the router, acks at "
              f"{json.dumps([round(x, 6) for x in fan_acks])} s: F0 level with L0 "
              f"(cursor {lsn}) {fan_acks[-1]:.6f} s after the first request; its mirror's "
              f"first read {t_first_read:.6f} s, equal to (a)'s on {card}", flush=True)

        # the serve documents: the base, then rounds of one delta chunk, by
        # CLUSTER_CLIENTS client threads through the router
        clients = [amtpu.RetryingClient(raddr, deadline_s=300, timeout_s=300, seed=k)
                   for k in range(CLUSTER_CLIENTS)]
        handles = [None] * CLUSTER_DOCS
        rtts, lags, round_s = [], [], []
        lock = threading.Lock()
        base64_base = base64.b64encode(base).decode("ascii")

        def mirror_of(i):
            return f0.rpc._docs[f0.rpc._durable_names[names[i]]]

        def write(k, r):
            c = clients[k]
            for i in range(k, CLUSTER_DOCS, CLUSTER_CLIENTS):
                if r == 0:
                    handles[i] = c.call("openDurable", name=names[i])["doc"]
                    data, want = base64_base, None
                else:
                    blob = deltas[i][r - 1]
                    data, want = base64.b64encode(blob).decode("ascii"), \
                        parse_change(blob)[0].hash
                t = time.perf_counter()
                c.call("applyChanges", doc=handles[i], data=data)
                t_ack = time.perf_counter()
                if want is not None and i in group0:
                    # the leader acked after F0's durable apply: how long
                    # until F0's mirror holds the change
                    dd = mirror_of(i)
                    while True:
                        with dd.lock:
                            if want in dd.device_doc.current_heads():
                                break
                        time.sleep(0.0005)
                    with lock:
                        lags.append(time.perf_counter() - t_ack)
                with lock:
                    rtts.append(t_ack - t)

        def one_round(r):
            errs = []

            def worker(k):
                try:
                    write(k, r)
                except BaseException as e:  # noqa: BLE001 - raised below
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(k,))
                  for k in range(CLUSTER_CLIENTS)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if errs:
                raise errs[0]
            if r:
                for i in range(CLUSTER_DOCS):
                    models[i].apply_changes([parse_change(deltas[i][r - 1])[0]])

        cap = None
        for r in range(CLUSTER_FAILOVER_ROUND + 1):
            if r == CLUSTER_CAPTURE_ROUND:
                _, cap = capture("cluster_round", lambda: one_round(r))
                cap["round_s"] = round_s[-1]
            else:
                one_round(r)
        # F0's drains are the round's only launches; the trace's join of a
        # range to its kernels (by the launching thread's id) has read
        # 152, 76 and 0 of them on the same round in three runs, so the
        # ranges and the window's kernels are checked apart
        got = cap["ranges"].get("amtpu.batched_launch", {}).get("count", 0)
        if got < 1 or cap["kernels"] < 1 or not 0 < cap["busy_share"] < 1:
            raise AssertionError(f"cluster (t) capture: {got} amtpu.batched_launch "
                                 f"ranges, {cap['kernels']} kernels, busy share "
                                 f"{cap['busy_share']}")
        t_rounds = time.perf_counter() - t_phase0

        # every F0 mirror equals its leader's document, and a fresh resolve
        # on the card of F0's host history
        def check_mirrors(where, node, idxs, model_of):
            for i in idxs:
                dd = node.rpc._docs[node.rpc._durable_names[names[i]]]
                with dd.lock:
                    mirror = dd.device_doc
                    if mirror is None or mirror.device.type != "cuda":
                        raise AssertionError(f"{where} {names[i]}: no mirror on the card")
                    fresh = DeviceDoc.merge([dd.doc], device=device)
                    check_fetch_equal(f"{where} {names[i]}", mirror, fresh)
                    if mirror.text(W.SERVE_LIVE) != model_of(i):
                        raise AssertionError(f"{where} {names[i]}: live differs from "
                                             "the document's")

        t0 = time.perf_counter()
        for i in group0:
            got = ctl.call("text", doc=handles[i], obj=W.SERVE_LIVE)
            if got != models[i].text(W.SERVE_LIVE):
                raise AssertionError(f"cluster {names[i]}: the leader's text differs")
        check_mirrors("cluster F0 mirror", f0, group0,
                      lambda i: models[i].text(W.SERVE_LIVE))
        with fdoc.lock:
            check_fetch_equal("cluster F0 fan-in mirror", fdoc.device_doc,
                              DeviceDoc.merge([fdoc.doc], device=device))
        t_check = time.perf_counter() - t0

        # the pipelined drain: L0's retained records of the group-0 serve
        # documents shipped to F2 as one stream, each document's base as a
        # snapshot (its mirror rebuilt), then every replApply frame of the
        # deltas in one write, so F2's drains hold several documents
        f2c = amtpu.RetryingClient(addr(f2), deadline_s=300, timeout_s=300)
        frames = []
        for i in group0:
            f2c.call("openDurable", name=names[i], device=True)
            f2c.call("replSnapshot", name=names[i], stream=CLUSTER_STREAM, lsn=1,
                     snapshot=base64_base, cursor=base64.b64encode(
                         encode_cursor(CLUSTER_STREAM, 1)).decode("ascii"))
            records, last, _ = l0.rpc.hub.tail_after(names[i], 1)
            frames.append({"id": 1000 + i, "method": "replApply", "params": {
                "name": names[i], "stream": CLUSTER_STREAM, "prev": 1, "lsn": last,
                "data": base64.b64encode(encode_batch(records)).decode("ascii"),
                "cursor": base64.b64encode(
                    encode_cursor(CLUSTER_STREAM, last)).decode("ascii")}})
        f2c.close()
        n_f2 = len(drains)
        sock = socket.create_connection(f2.address, timeout=300)
        t0 = time.perf_counter()
        sock.sendall("".join(json.dumps(f) + "\n" for f in frames).encode())
        rf = sock.makefile("r")
        answers = [json.loads(rf.readline()) for _ in frames]
        t_pipe = time.perf_counter() - t0
        sock.close()
        bad = [a for a in answers if "error" in a]
        if bad:
            raise AssertionError(f"cluster pipelined drain: {bad[:2]}")
        check_mirrors("cluster F2 mirror", f2, group0,
                      lambda i: models[i].text(W.SERVE_LIVE))
        pipe = [d for d in drains[n_f2:] if d["node"] == "F2"]
        packed = [x["batched"] for d in pipe for x in d["launches"] or ()]
        if not packed or max(packed) < 2:
            raise AssertionError(f"cluster pipelined drain: documents a packed launch "
                                 f"{packed}")

        # failover: L0 stops; the router promotes F0; the first acked write
        # is a commit to a new document placed on group 0
        probe = next(f"probe{k}" for k in range(1000) if ring.member_for(f"probe{k}") == 0)
        t_stop = time.perf_counter()
        l0.stop()
        nodes.remove(l0)
        ph = ctl.call("openDurable", name=probe)["doc"]
        ctl.call("put", doc=ph, obj="_root", prop="after", value="failover")
        ctl.call("commit", doc=ph)
        t_failover = time.perf_counter() - t_stop
        info = ctl.call("clusterInfo")
        if info["groups"][0]["leader"] != addr(f0) or f0.rpc.cluster_role != "leader" \
                or probe not in f0.rpc._durable_names:
            raise AssertionError(f"cluster: F0 not promoted: {info['groups'][0]}")
        # every write acked before the stop, read through the router
        for i in range(CLUSTER_DOCS):
            got = ctl.call("text", doc=handles[i], obj=W.SERVE_LIVE)
            if got != models[i].text(W.SERVE_LIVE):
                raise AssertionError(f"cluster {names[i]}: an acked write is missing "
                                     "after the failover")
        if ctl.call("text", doc=fh, obj=held["text_obj"]) != held["text"]:
            raise AssertionError("cluster: the fan-in's text differs after the failover")

        # the remaining rounds: group 0's documents synced into F0 (their
        # sessions feed F0's mirrors through its batcher), group 1's applied
        sessions = {}
        for i in group0:
            peer = AutoDoc(ActorId(bytes([CLUSTER_ACTOR + 1, i]) * 8), device="cpu")
            peer.apply_changes(models[i].get_changes([]))
            s = clients[i % CLUSTER_CLIENTS].call("syncSessionNew", doc=handles[i],
                                                  epoch=2, timeoutMs=600_000)
            sessions[i] = (peer, SyncSession(peer, epoch=1), s["session"])

        def converse(c, i, now):
            peer, ps, ss = sessions[i]
            for k in range(40):
                frame = ps.poll(now + k)
                if frame is not None:
                    c.call("syncSessionReceive", session=ss,
                           data=base64.b64encode(frame).decode("ascii"))
                back = c.call("syncSessionPoll", session=ss)
                if back is not None:
                    ps.receive(base64.b64decode(back), now + k)
                if (frame is None and back is None and ps.converged()
                        and c.call("syncSessionStats", session=ss)["converged"]):
                    return
            raise AssertionError(f"cluster {names[i]}: the sessions did not converge")

        def write_after(k, r):
            c = clients[k]
            for i in range(k, CLUSTER_DOCS, CLUSTER_CLIENTS):
                blob = deltas[i][r - 1]
                if i in sessions:
                    sessions[i][0].apply_changes([parse_change(blob)[0]])
                    converse(c, i, 1000.0 * r)
                else:
                    c.call("applyChanges", doc=handles[i],
                           data=base64.b64encode(blob).decode("ascii"))

        for r in range(CLUSTER_FAILOVER_ROUND + 1, CLUSTER_ROUNDS + 1):
            errs = []

            def worker(k, r=r):
                try:
                    write_after(k, r)
                except BaseException as e:  # noqa: BLE001 - raised below
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(k,))
                  for k in range(CLUSTER_CLIENTS)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if errs:
                raise errs[0]
            for i in range(CLUSTER_DOCS):
                models[i].apply_changes([parse_change(deltas[i][r - 1])[0]])
        for i in range(CLUSTER_DOCS):
            if models[i].text(W.SERVE_LIVE) != texts[i]:
                raise AssertionError(f"cluster {names[i]}: the model is not the generator's")
            if ctl.call("text", doc=handles[i], obj=W.SERVE_LIVE) != texts[i]:
                raise AssertionError(f"cluster {names[i]}: the text through the router "
                                     "differs from the generator's")
        check_mirrors("cluster promoted F0 mirror", f0, group0, lambda i: texts[i])

        # migration: a warm serve document, then the fan-in, to group 1
        mig = {}
        warm = names[group0[1]]
        f0.rpc.store.demote(warm, "warm", "smoke")
        for name, h, obj, want in ((warm, handles[group0[1]], W.SERVE_LIVE,
                                    texts[group0[1]]),
                                   (fan, fh, held["text_obj"], held["text"])):
            t0 = time.perf_counter()
            res = ctl.call("clusterMigrate", name=name, to=1)
            mig[name] = time.perf_counter() - t0
            if not res.get("migrated"):
                raise AssertionError(f"cluster: {name} not migrated: {res}")
            if ctl.call("text", doc=h, obj=obj) != want:
                raise AssertionError(f"cluster: {name}'s text changed in the migration")
            if name in f0.rpc._durable_names or f0.rpc.store.tier(name) is not None:
                raise AssertionError(f"cluster: F0 did not release {name}")
            if name not in l1.rpc._durable_names:
                raise AssertionError(f"cluster: L1 does not hold {name}")
        counts["cluster"] = kernels.launch_counts()
        check_launches("cluster", counts["cluster"], RUN_NATIVE + ("scatter_winners",),
                       TRANSPORT_ONLY)
        # the follower drains' own: F0's feeds before the failover
        f0d = [d for d in drains if d["node"] == "F0"]
        fed = dict.fromkeys(counts["cluster"], 0)
        for d in f0d:
            for k, v in d["kernels"].items():
                fed[k] += v
        counts["cluster follower"] = fed
        check_launches("cluster follower", fed, RUN_NATIVE + ("scatter_winners",),
                       TRANSPORT_ONLY)
        hist = [e for e in obs.snapshot() if e["name"] == "cluster.repl_apply_batch_size"]
        if not hist or hist[0]["count"] < 1:
            raise AssertionError("cluster: cluster.repl_apply_batch_size has no "
                                 "observations")
        lock_hist = [e for e in obs.snapshot()
                     if e["name"] == "cluster.resync_lock_seconds"]
        if not lock_hist or lock_hist[0]["count"] < len(group0):
            raise AssertionError("cluster: the snapshot resyncs observed no "
                                 "cluster.resync_lock_seconds")
        errors = obs.counter_values("rpc.errors", "type")
        feed_errors = obs.legacy_counters.get("cluster.repl_device_feed_error", 0)
        if feed_errors:
            raise AssertionError(f"cluster: {feed_errors} follower feed errors")
        torch.cuda.synchronize()
        if int((torch.ones(4, device=device) * 2).sum()) != 8:
            raise AssertionError("cluster: a launch after the nodes' threads went wrong")

        per_launch = [x["batched"] for d in f0d for x in d["launches"] or ()]
        rt = {"p50": statistics.median(rtts), "p95": statistics.quantiles(rtts, n=20)[18]}
        print(f"cluster (t) writes: {CLUSTER_DOCS} serve documents by {CLUSTER_CLIENTS} "
              f"client threads through the router; quorum-acked applyChanges round "
              f"trip p50 {rt['p50']:.6f} s p95 {rt['p95']:.6f} s over {len(rtts)} calls; "
              f"rounds 0-{CLUSTER_FAILOVER_ROUND} {t_rounds:.6f} s (a round p50 "
              f"{statistics.median(round_s[1:CLUSTER_FAILOVER_ROUND + 1]):.6f} s); "
              f"replication lag (leader's ack to F0's mirror holding the change) p50 "
              f"{statistics.median(lags):.6f} s max {max(lags):.6f} s over {len(lags)} "
              f"writes on {card}", flush=True)
        docs_a_drain = [d["docs"] for d in f0d]
        print(f"cluster (t) F0 drains: {len(f0d)}, documents a drain mean "
              f"{statistics.mean(docs_a_drain):.3f} max {max(docs_a_drain)}, drain s p50 "
              f"{statistics.median(d['s'] for d in f0d):.6f} max "
              f"{max(d['s'] for d in f0d):.6f}; packed launches {len(per_launch)}, "
              f"documents a launch max {max(per_launch)} (one leader ships one "
              f"replApply at a time); cluster.repl_apply_batch_size (F0 and F2) count "
              f"{hist[0]['count']} mean {hist[0]['sum'] / hist[0]['count']:.3f} max "
              f"{hist[0]['max']}; F2's pipelined drain of {len(frames)} documents in "
              f"{t_pipe:.6f} s: drains {len(pipe)}, documents a packed launch "
              f"{packed}; a snapshot resync held its document's lock (the mirror "
              f"rebuilt inside it; cluster.resync_lock_seconds) {lock_hist[0]['count']} "
              f"times, mean {lock_hist[0]['sum'] / lock_hist[0]['count']:.6f} s, max "
              f"{lock_hist[0]['max']:.6f} s; F0's drains launched "
              + json.dumps({k: v for k, v in fed.items() if v}) + f" on {card}",
              flush=True)
        print(f"cluster (t) capture of round {CLUSTER_CAPTURE_ROUND}: the round "
              f"{cap['round_s']:.6f} s, {cap['kernels']} kernels, device busy "
              f"{cap['busy_s']:.6f} s, busy share {cap['busy_share']:.7f}; ranges "
              f"{json.dumps(cap['ranges'])} on {card}", flush=True)
        print(f"cluster (t) failover: L0 stopped after round {CLUSTER_FAILOVER_ROUND}; "
              f"the stop to the first acked write on F0 {t_failover:.6f} s; every acked "
              f"write read back through the router; rounds "
              f"{CLUSTER_FAILOVER_ROUND + 1}-{CLUSTER_ROUNDS} p50 "
              f"{statistics.median(round_s[CLUSTER_FAILOVER_ROUND + 1:]):.6f} s, group "
              f"0's by sync sessions into F0's mirrors; every mirror equals its document "
              f"and a fresh resolve ({t_check:.3f} s of checks before the failover) on "
              f"{card}", flush=True)
        print(f"cluster (t) migration to group 1: the warm serve document "
              f"{mig[warm]:.6f} s, the fan-in {mig[fan]:.6f} s; texts unchanged, F0 "
              f"released both; rpc errors {json.dumps(errors)}; launches "
              + json.dumps({k: v for k, v in counts['cluster'].items() if v})
              + f" on {card}", flush=True)
        for c in clients + [ctl]:
            c.close()
    finally:
        if restore is not None:
            restore()
        if router is not None:
            router.stop()
        for n in nodes:
            n.stop()
        sys.setswitchinterval(switch)
    return counts


def cluster_paths(card: str, device) -> dict:
    """(t) the cluster tier: two groups and a router in process on the
    card. Returns the launch counts by path."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="amtpu-cluster-")
    try:
        counts = cluster_in_process(card, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"cluster (t): the phase took {time.perf_counter() - t_phase:.3f} s "
          f"on {card}", flush=True)
    return counts


# -- the command line, the native edit sessions and the dot dump (phase u) -----
# (u) the typing trace's 260,000 edits through the sessions; its first
# U_COMPARE_EDITS typed both ways for the bytes (cut from 260,000: the Python
# path types about 5,000 edits a second on the card's host); U_RECORDS of
# (b)'s records put both ways (cut from 65,536, 50 s both ways, to keep the
# smoke near its time with (v) added); a mirrored durable document and the
# command line
U_COMPARE_EDITS = 24_000
U_COMMIT_EVERY = 1_000
U_RECORDS = 16_384
U_DURABLE_EDITS = 8_192
U_CLI_FILES = 8  # the base and the first 128 replicas, then 7 x 128 replicas
U_ACTOR = bytes([0x75]) * 16


def replay_text(edits) -> str:
    """The text ``edits`` ([pos, ndel, *chars]) leave, replayed on a list."""
    text = []
    for pos, ndel, *chars in edits:
        del text[pos:pos + ndel]
        text[pos:pos] = "".join(chars)
    return "".join(text)


def session_doc(device, sessions: bool):
    """An ``AutoDoc`` on ``device`` whose transactions use the native edit
    sessions, or (``sessions=False``) the Python path alone."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.types import ActorId

    class PlainDoc(AutoDoc):
        def _ensure_tx(self):
            tx = super()._ensure_tx()
            tx.enable_sessions = False
            return tx

    return (AutoDoc if sessions else PlainDoc)(ActorId(U_ACTOR), device=device)


def type_trace(doc, edits, every: int, after_commit=None) -> tuple:
    """``edits`` typed one ``splice_text`` at a time into a new text object
    "text", a commit every ``every`` edits (no timestamp, as ``am_commit``
    makes them); returns (text object, seconds, commits)."""
    from automerge_tpu_torch.types import ObjType

    t = doc.put_object("_root", "text", ObjType.TEXT)
    doc.commit()
    commits = 0
    t0 = time.perf_counter()
    for i, (pos, ndel, *chars) in enumerate(edits):
        doc.splice_text(t, pos, ndel, "".join(chars))
        if i % every == every - 1:
            doc.commit()
            commits += 1
            if after_commit is not None:
                after_commit()
    if doc.commit() is not None:
        commits += 1
        if after_commit is not None:
            after_commit()
    return t, time.perf_counter() - t0, commits


def put_records(doc, n: int) -> float:
    """(b)'s record store put field by field through ``AutoDoc.put``: each
    record a map under ``records`` with its seven scalar fields and its
    ``votes`` counter, as ``workload.record_base_change`` makes them; one
    commit. Returns the seconds."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.types import ObjType, ScalarValue

    base = W.record_base_change(n)
    t0 = time.perf_counter()
    records = doc.put_object("_root", "records", ObjType.MAP)
    ops = base.ops
    for r in range(n):
        make = ops[1 + r * W._OPS_PER_RECORD]
        rec = doc.put_object(records, make.key.prop, ObjType.MAP)
        for op in ops[2 + r * W._OPS_PER_RECORD:1 + (r + 1) * W._OPS_PER_RECORD]:
            v = op.value
            doc.put(rec, op.key.prop,
                    ScalarValue("counter", v.value) if v.tag == "counter" else v.to_py())
    doc.commit(timestamp=3)
    return time.perf_counter() - t0


def put_flat(doc, n: int) -> float:
    """One field of each of (b)'s first ``n`` records put into one flat map
    ``index`` made in an earlier commit, all in one commit: with the
    sessions on, every put goes through the put cache and its map session.
    Returns the seconds."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.types import ObjType

    index = doc.put_object("_root", "index", ObjType.MAP)
    doc.commit(timestamp=5)
    values = [W._field_value(W.RECORD_FIELDS[0][1], i).to_py() for i in range(n)]
    keys = [W._record_key(i) for i in range(n)]
    t0 = time.perf_counter()
    for k, v in zip(keys, values):
        doc.put(index, k, v)
    if doc._tx.enable_sessions and not doc._tx._msessions:
        raise AssertionError("flat puts: the put cache held no map session")
    doc.commit(timestamp=6)
    return time.perf_counter() - t0


def check_doc_merge(path: str, counts: dict) -> None:
    """A document's merge ran on the card: the run-native staging's kernels
    and one of the two winners kernels, none of the packed transport's."""
    check_launches(path, counts, RUN_NATIVE, TRANSPORT_ONLY)
    if counts["scatter_winners"] + counts["sort_winners"] < 1:
        raise AssertionError(f"{path}: no winners kernel launched")


def cli_main(argv) -> int:
    from automerge_tpu_torch import cli

    return cli.main(["--device", "cuda", *argv])


def cli_sessions_paths(card: str, device) -> dict:
    """(u) the native edit sessions, the command line and the dot dump on
    the card (see the module docstring). Returns the launch counts by
    path."""
    import shutil
    import tempfile

    from automerge_tpu_torch import kernels, native, visualisation
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.core.transaction import Transaction
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.oplog import OpLog
    from automerge_tpu_torch.types import ActorId

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fc = native.fastcall()
    print(f"sessions (u): the fastcall extension {fc.__name__} "
          f"({native._fastcall_path().name}) loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    counts = {}
    text_must = TEXT_MERGE_MUST

    # 1. the typing trace through the sessions, then a prefix of it both ways
    edits = W.load_trace()
    want = replay_text(edits)
    doc = session_doc(device, True)
    kernels.reset_launches()
    with gc_pauses() as pauses:
        text_obj, typed_s, commits = type_trace(doc, edits, U_COMMIT_EVERY)
        torch.cuda.synchronize()
    typing_counts = kernels.launch_counts()
    counts["typing sessions"] = typing_counts
    if not doc.doc._ops_stale:
        raise AssertionError("typing: the last session commit left the op store live")
    merges = typing_counts["succ_vis"] // SV_LAUNCHES
    if any(typing_counts.values()):
        raise AssertionError(f"typing: the commits rebuilt the op store: {typing_counts}")
    print(f"typing sessions (u): {len(edits)} edits (load_trace's "
          f"{W.TRACE_EDITS}) in {typed_s:.3f} s, {len(edits) / typed_s:.1f} edits/s "
          f"(gc {sum(s for _, s in pauses):.3f} s), {commits} commits of "
          f"{U_COMMIT_EVERY}, each past SMALL_TAIL_OPS = "
          f"{Transaction.SMALL_TAIL_OPS}, each keeping its session: {merges} "
          f"rebuilds, no launches on {card}", flush=True)
    seconds = {}

    def read_and_rebuild():
        t0 = time.perf_counter()
        got = doc.text(text_obj)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = doc.length(text_obj)
        torch.cuda.synchronize()
        seconds["read"], seconds["rebuild"] = t1 - t0, time.perf_counter() - t1
        return got, n

    kernels.reset_launches()
    (got, n), cap = capture("typing_rebuild", read_and_rebuild)
    counts["typing sessions read"] = kernels.launch_counts()
    check_doc_merge("typing sessions read", counts["typing sessions read"])
    if got != want or n != len(want):
        raise AssertionError("typing: the text after the session commits is not "
                             "the trace's")
    if doc.doc._ops_stale:
        raise AssertionError("typing: the read left the op store stale")
    t0 = time.perf_counter()
    data = doc.save()
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    print(f"typing sessions (u): the stale read {seconds['read']:.6f} s, the "
          f"op-store rebuild {seconds['rebuild']:.6f} s (window {cap['window_s']:.6f} "
          f"s, busy share {cap['busy_share']:.7f}, {cap['kernels']} kernels), the "
          f"text the trace's {len(want)} characters; save {save_s:.6f} s, "
          f"{len(data)} bytes; read launches "
          + json.dumps({k: v for k, v in counts["typing sessions read"].items() if v})
          + f" on {card}", flush=True)
    CAPI_INPUT.update(typed=data, text=want)
    del doc, data
    prefix = edits[:U_COMPARE_EDITS]
    typed, rate = {}, {}
    for sessions in (True, False):
        typed[sessions] = session_doc(device, sessions)
        with gc_pauses():
            _, secs_, _ = type_trace(typed[sessions], prefix, U_COMMIT_EVERY)
        rate[sessions] = len(prefix) / secs_
    data = typed[True].save()
    if data != typed[False].save():
        raise AssertionError("typing: the sessions' save differs from the Python path's")
    CAPI_INPUT["prefix"] = data
    print(f"typing sessions (u): the first {len(prefix)} edits typed both ways, "
          f"{rate[True]:.1f} edits/s through the sessions and {rate[False]:.1f} on "
          f"the Python path; saves equal, {len(data)} bytes", flush=True)
    del typed, data

    # 2. the record store's puts through the put cache, then with them off
    docs, secs = {}, {}
    for sessions in (True, False):
        docs[sessions] = session_doc(device, sessions)
        secs[sessions] = put_records(docs[sessions], U_RECORDS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    data = docs[True].save()
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    counts["records sessions save"] = kernels.launch_counts()
    check_doc_merge("records sessions save", counts["records sessions save"])
    if data != docs[False].save():
        raise AssertionError("records: the sessions' save differs from the Python path's")
    back = AutoDoc.load(data, device=device)
    if len(back.keys(back.get("_root", "records")[0][2])) != U_RECORDS:
        raise AssertionError("records: the loaded document lost records")
    puts = U_RECORDS * (1 + len(W.RECORD_FIELDS) + 1)
    print(f"records sessions (u): {U_RECORDS} of (b)'s records x "
          f"{len(W.RECORD_FIELDS) + 1} fields, {puts} puts through AutoDoc.put in "
          f"{secs[True]:.3f} s ({puts / secs[True]:.1f} puts/s), the Python path "
          f"{secs[False]:.3f} s ({puts / secs[False]:.1f} puts/s); save "
          f"{save_s:.6f} s, {len(data)} bytes, equal; save launches " + json.dumps(
              {k: v for k, v in counts["records sessions save"].items() if v})
          + f" on {card}", flush=True)
    del docs, back, data
    docs, secs = {}, {}
    for sessions in (True, False):
        docs[sessions] = session_doc(device, sessions)
        secs[sessions] = put_flat(docs[sessions], W.RECORDS)
    data = docs[True].save()
    if data != docs[False].save():
        raise AssertionError("flat puts: the sessions' save differs from the Python path's")
    print(f"flat puts (u): {W.RECORDS} puts into one map through the put cache in "
          f"{secs[True]:.3f} s ({W.RECORDS / secs[True]:.1f} puts/s), the Python path "
          f"{secs[False]:.3f} s ({W.RECORDS / secs[False]:.1f} puts/s); saves equal, "
          f"{len(data)} bytes", flush=True)
    del docs, data

    root = tempfile.mkdtemp(prefix="amtpu-cli-")
    try:
        # 3. a mirrored durable document typed through the sessions, its
        # mirror fed each commit's change
        path = os.path.join(root, "typed")
        dd = AutoDoc.open(path, mirror=True, device=device, actor=ActorId(U_ACTOR))
        fed = []

        def feed():
            heads = fed[-1] if fed else []
            new = dd.get_changes(heads)
            dd.device_doc.apply_changes([c.raw_bytes for c in new])
            fed.append(dd.get_heads())

        kernels.reset_launches()
        dtext, dur_s, dcommits = type_trace(dd, edits[:U_DURABLE_EDITS],
                                            U_COMMIT_EVERY, feed)
        torch.cuda.synchronize()
        counts["durable sessions feed"] = kernels.launch_counts()
        check_launches("durable sessions feed", counts["durable sessions feed"],
                       RUN_NATIVE, TRANSPORT_ONLY)
        fresh = DeviceDoc.resolve(OpLog.from_changes(
            [a.stored for a in dd.doc.history]), device=device)
        check_fetch_equal("durable sessions mirror", dd.device_doc, fresh)
        dwant = replay_text(edits[:U_DURABLE_EDITS])
        if dd.device_doc.text(dtext) != dwant or dd.text(dtext) != dwant:
            raise AssertionError("durable sessions: the mirror's text is not the trace's")
        dd.close()
        again = AutoDoc.open(path, mirror=True, device=device)
        check_fetch_equal("durable sessions reopened", again.device_doc, fresh)
        typed = os.path.join(root, "typed.automerge")
        with open(typed, "wb") as fh:
            fh.write(again.save())
        again.close()
        print(f"durable sessions (u): {U_DURABLE_EDITS} edits through the sessions "
              f"into AutoDoc.open(mirror=True) in {dur_s:.3f} s, {dcommits} commits "
              f"each fed to the mirror; the mirror, and the one reopened, equal a "
              f"fresh resolve; feed launches " + json.dumps(
                  {k: v for k, v in counts["durable sessions feed"].items() if v})
              + f" on {card}", flush=True)

        # 4. the command line in process on the card
        held = FANINS["text"]
        blobs, text = held["blobs"], held["text"]
        per = (len(blobs) - 1) // U_CLI_FILES
        files = []
        for i in range(U_CLI_FILES):
            f = os.path.join(root, f"replicas{i}.automerge")
            with open(f, "wb") as fh:
                fh.write(b"".join([blobs[0], *blobs[1 + i * per:1 + (i + 1) * per]]))
            files.append(f)
        merged = os.path.join(root, "merged.automerge")
        cli_s = {}

        def run(name, argv, path=None):
            if path is not None:
                kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            cli_s[name] = time.perf_counter() - t0
            if path is not None:
                counts[path] = kernels.launch_counts()
            if rc != 0:
                raise AssertionError(f"cli {name}: exit {rc}")

        run("merge", ["merge", *files, "-o", merged], "cli merge")
        check_launches("cli merge", counts["cli merge"], *text_must)
        with open(merged, "rb") as fh:
            CAPI_INPUT["merged"] = fh.read()
        run("export", ["export", merged, "-o", merged + ".json"], "cli export")
        check_doc_merge("cli export", counts["cli export"])
        with open(merged + ".json") as fh:
            exported = json.load(fh)
        if exported.get("text") != text:
            raise AssertionError("cli merge: the merged text is not (a)'s")
        run("examine", ["examine", merged, "-o", merged + ".changes.json"])
        with open(merged + ".changes.json") as fh:
            changes = json.load(fh)
        if len(changes) != len(blobs):
            raise AssertionError(f"cli examine: {len(changes)} changes, not {len(blobs)}")
        del changes
        changed = os.path.join(root, "changed.automerge")
        run("change", ["change", typed, "splice .text 0 0 'cli '", "-o", changed],
            "cli change")
        check_doc_merge("cli change", counts["cli change"])
        run("export changed", ["export", changed, "-o", changed + ".json"])
        with open(changed + ".json") as fh:
            if json.load(fh)["text"] != "cli " + dwant:
                raise AssertionError("cli change: the splice did not land")
        run("metrics", ["metrics", path, "-o", os.path.join(root, "metrics.prom")])
        run("journal-info", ["journal-info", path, "--verify",
                             "-o", os.path.join(root, "info.json")])
        with open(os.path.join(root, "info.json")) as fh:
            info = json.load(fh)
        if not all(v["ok"] for v in info["verify"]):
            raise AssertionError(f"cli journal-info: {info['verify']}")
        run("compact", ["compact", path, "-o", os.path.join(root, "compact.json")])
        with open(os.path.join(root, "compact.json")) as fh:
            if json.load(fh)["compacted"] is not True:
                raise AssertionError("cli compact: not compacted")
        print(f"cli (u): merge of {U_CLI_FILES} files ({sum(map(os.path.getsize, files))} "
              f"bytes: the base with {per} replicas' changes each) {cli_s['merge']:.3f} s, "
              f"the merged text (a)'s; seconds " + json.dumps(
                  {k: round(v, 6) for k, v in cli_s.items()})
              + "; merge launches " + json.dumps(
                  {k: v for k, v in counts["cli merge"].items() if v})
              + f" on {card}", flush=True)

        # 5. the command line as a process, on the card by default
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "automerge_tpu_torch", "export",
                            merged, "-o", merged + ".sub.json"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"python -m automerge_tpu_torch export: exit "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        with open(merged + ".json", "rb") as a, open(merged + ".sub.json", "rb") as b:
            if a.read() != b.read():
                raise AssertionError("python -m automerge_tpu_torch export: the "
                                     "JSON differs from the in-process export's")
        print(f"cli (u): python -m automerge_tpu_torch export of the merged file "
              f"(the card by default) exit 0 in {sub_s:.3f} s, the same JSON",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 6. a dot dump of a small document typed through the sessions
    small = session_doc(device, True)
    st, _, _ = type_trace(small, edits[:300], 100)
    small.put("_root", "k", 1)
    small.commit(timestamp=4)
    dot = visualisation.doc_to_dot(small)
    if not dot.startswith("digraph automerge") or dot.count("subgraph") != 2:
        raise AssertionError("dot: not a two-object dump")
    print(f"dot (u): {len(dot)} characters, {dot.count('->')} edges; "
          f"changes_to_dot {len(visualisation.changes_to_dot(small))} characters",
          flush=True)
    print(f"sessions (u): the phase took {time.perf_counter() - t_phase:.3f} s on "
          f"{card}", flush=True)
    return counts


# -- the C ABI on the card (phase v) ---------------------------------------------
# what (u) leaves for (v): the session-typed save of the whole trace and its
# text, the save of its first U_COMPARE_EDITS edits, and the CLI's merged file
CAPI_INPUT = {}
CAPI_TIMEOUT = 600  # seconds a C process of (v) may take


def c_calls(lib) -> ctypes.CDLL:
    """``lib`` (the port's cdylib) loaded with the signatures (v) calls."""
    am = ctypes.CDLL(lib)
    vp, cp, sz = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
    for name, res, args in (
            ("am_init", ctypes.c_int, []),
            ("am_load", vp, [ctypes.c_char_p, sz]),
            ("am_map_get", vp, [vp, cp, cp]),
            ("am_text", vp, [vp, cp]),
            ("am_save", vp, [vp]),
            ("am_result_status", ctypes.c_int, [vp]),
            ("am_result_error", cp, [vp]),
            ("am_item_str", cp, [vp, sz]),
            ("am_item_bytes", ctypes.POINTER(ctypes.c_uint8),
             [vp, sz, ctypes.POINTER(sz)]),
            ("am_result_free", None, [vp]),
            ("am_doc_free", None, [vp])):
        getattr(am, name).restype = res
        getattr(am, name).argtypes = args
    return am


def c_result(am, r, what: str, kind: str = "str"):
    """The first item of result ``r`` (freed), raising on an error."""
    try:
        if am.am_result_status(r) != 0:
            raise AssertionError(f"{what}: {am.am_result_error(r).decode()}")
        if kind == "bytes":
            n = ctypes.c_size_t()
            p = am.am_item_bytes(r, 0, ctypes.byref(n))
            return ctypes.string_at(p, n.value)
        return am.am_item_str(r, 0).decode()
    finally:
        am.am_result_free(r)


def run_c_processes(cmds: dict, env: dict, root: str) -> dict:
    """``cmds`` (name -> argv) run at once; returns name -> (seconds,
    stdout). Each must exit 0 within CAPI_TIMEOUT."""
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name, argv in cmds.items():
        fh = open(os.path.join(root, f"{name}.out"), "w+")
        procs[name] = (subprocess.Popen(argv, stdout=fh, stderr=subprocess.STDOUT,
                                        env=env, cwd=root), fh)
    try:
        while len(out) < len(procs):
            if time.perf_counter() - t0 > CAPI_TIMEOUT:
                raise AssertionError(f"C processes still running after {CAPI_TIMEOUT} "
                                     f"s: {sorted(set(procs) - set(out))}")
            for name, (p, fh) in procs.items():
                if name not in out and p.poll() is not None:
                    fh.seek(0)
                    out[name] = (time.perf_counter() - t0, fh.read())
                    if p.returncode != 0:
                        raise AssertionError(f"C process {name}: exit {p.returncode}: "
                                             f"{out[name][1][-3000:]}")
            time.sleep(0.02)
    finally:
        for p, fh in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            fh.close()
    return out


def capi_paths(card: str, device) -> dict:
    """(v) the C ABI on the card (see the module docstring). Returns the
    launch counts by path."""
    import re
    import shutil
    import tempfile

    from automerge_tpu_torch import capi, kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.capi import edits as E
    from automerge_tpu_torch.capi import shim

    t_phase = time.perf_counter()
    counts = {}
    root = tempfile.mkdtemp(prefix="amtpu-capi-")
    try:
        # 1. the library, the five suites and the typist
        t0 = time.perf_counter()
        lib = capi.build()
        lib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exes = {src: capi.build_test(lib, root, source=src) for src in capi.TEST_SOURCES}
        typist = capi.build_test(lib, root, source="type_edits.c")
        typist_so = capi.build_test(lib, root, source="type_edits.c", shared=True)
        print(f"capi (v): {os.path.basename(lib)} in {lib_s:.3f} s (g++, with cache "
              f"check), the five suites and the typist (executable and shared "
              f"library) in {time.perf_counter() - t0:.3f} s (gcc)", flush=True)

        # 2. the suites and the typist on (u)'s compared prefix as processes at
        # once, on the card: no device setting
        edits = W.load_trace()
        prefix_file = os.path.join(root, "prefix.bin")
        with open(prefix_file, "wb") as fh:
            fh.write(E.encode(E.from_trace(edits[:U_COMPARE_EDITS])))
        env = {k: v for k, v in os.environ.items() if k != "AUTOMERGE_TPU_TORCH_DEVICE"}
        env["PYTHONPATH"] = capi.python_path()
        cmds = {os.path.splitext(src)[0]: [exe] for src, exe in exes.items()}
        cmds["type_edits"] = [typist, prefix_file, str(U_COMMIT_EVERY),
                              os.path.join(root, "prefix.automerge"), U_ACTOR.hex()]
        done = run_c_processes(cmds, env, root)
        for name in cmds:
            if name != "type_edits" and "all assertions passed" not in done[name][1]:
                raise AssertionError(f"C suite {name}: {done[name][1][-3000:]}")
        with open(os.path.join(root, "prefix.automerge"), "rb") as fh:
            if fh.read() != CAPI_INPUT["prefix"]:
                raise AssertionError("capi: the C typist's save of the prefix differs "
                                     "from the sessions' in (u)")
        line = done["type_edits"][1].strip().splitlines()[-1]
        m = re.match(r"typed (\d+) records in ([\d.]+) s \(am_init ([\d.]+) s, first "
                     r"am_text ([\d.]+) s\)", line)
        if m is None or int(m.group(1)) != U_COMPARE_EDITS:
            raise AssertionError(f"capi: the C typist printed {line!r}")
        print("capi (v): the five suites and the typist as processes at once "
              "on the card, seconds " + json.dumps(
                  {k: round(v[0], 6) for k, v in done.items()})
              + "; suites all assertions passed", flush=True)
        print(f"capi (v): the C typist process typed the first {U_COMPARE_EDITS} "
              f"edits in {float(m.group(2)):.6f} s ({U_COMPARE_EDITS / float(m.group(2)):.1f} "
              f"edits/s); am_init {float(m.group(3)):.6f} s (the embedded interpreter, "
              f"torch imported); the first am_text {float(m.group(4)):.6f} s (the "
              f"process's CUDA context, the kernels' library and the stale read's "
              f"merge); its save (u)'s byte for byte on {card}", flush=True)

        # 3. in this process through ctypes: am_load of (u)'s merged file, am_text
        am = c_calls(lib)
        t0 = time.perf_counter()
        if am.am_init() != 0:
            raise AssertionError("capi: am_init failed")
        init_s = time.perf_counter() - t0
        held = FANINS["text"]
        merged = CAPI_INPUT["merged"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        doc = am.am_load(merged, len(merged))
        if not doc:
            raise AssertionError("capi: am_load of the merged file failed")
        load_s = time.perf_counter() - t0
        text = c_result(am, am.am_text(doc, held["text_obj"].encode()), "am_text")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0 - load_s
        counts["capi load"] = kernels.launch_counts()
        check_launches("capi load", counts["capi load"], *TEXT_MERGE_MUST)
        if counts["capi load"]["succ_vis"] != SV_LAUNCHES:
            raise AssertionError(f"capi load: {counts['capi load']['succ_vis']} succ_vis "
                                 f"launches, not one merge's {SV_LAUNCHES}")
        if text != held["text"]:
            raise AssertionError("capi: am_text of the merged file is not (a)'s text")
        am.am_doc_free(doc)
        print(f"capi (v): am_init in this process {init_s:.6f} s (joins the running "
              f"interpreter); am_load of (u)'s merged file ({len(merged)} bytes) "
              f"{load_s:.6f} s, am_text {read_s:.6f} s, (a)'s text; launches "
              + json.dumps({k: v for k, v in counts["capi load"].items() if v})
              + f" on {card}", flush=True)

        # 4. the trace typed through the C hot-call cache in this process
        drv = ctypes.CDLL(typist_so)
        drv.type_edits.restype = ctypes.c_void_p
        drv.type_edits.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long)]
        trace_file = os.path.join(root, "trace.bin")
        with open(trace_file, "wb") as fh:
            fh.write(E.encode(E.from_trace(edits)))
        errors = os.path.join(root, "errors.txt")
        obj = ctypes.create_string_buffer(64)
        secs, n = ctypes.c_double(), ctypes.c_long()
        kernels.reset_launches()
        with gc_pauses() as pauses:
            doc = drv.type_edits(trace_file.encode(), U_COMMIT_EVERY, U_ACTOR,
                                 errors.encode(), obj, ctypes.byref(secs), ctypes.byref(n))
            torch.cuda.synchronize()
        counts["capi typing"] = kernels.launch_counts()
        with open(errors) as fh:
            failed = fh.read()
        if not doc or n.value != len(edits) or failed:
            raise AssertionError(f"capi: typing through the C cache: {n.value} of "
                                 f"{len(edits)} edits, errors {failed[:2000]!r}")
        if any(counts["capi typing"].values()):
            raise AssertionError(f"capi typing: the commits rebuilt the op store: "
                                 f"{counts['capi typing']}")
        c_rate = len(edits) / secs.value
        kernels.reset_launches()
        t0 = time.perf_counter()
        text = c_result(am, am.am_text(doc, obj.value), "am_text")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        counts["capi typing read"] = kernels.launch_counts()
        check_doc_merge("capi typing read", counts["capi typing read"])
        if text != CAPI_INPUT["text"]:
            raise AssertionError("capi: the text typed through the C cache is not "
                                 "the trace's")
        t0 = time.perf_counter()
        data = c_result(am, am.am_save(doc), "am_save", "bytes")
        save_s = time.perf_counter() - t0
        am.am_doc_free(doc)
        if data != CAPI_INPUT["typed"]:
            raise AssertionError("capi: the C cache's save differs from the sessions' "
                                 "save in (u)")
        print(f"capi typing (v): {len(edits)} edits through am_splice_text's hot-call "
              f"cache in this process in {secs.value:.6f} s, {c_rate:.1f} edits/s "
              f"(gc {sum(s for _, s in pauses):.3f} s), a commit every "
              f"{U_COMMIT_EVERY}, no launches; the read after typing {read_s:.6f} s, "
              f"the trace's {len(text)} characters, launches " + json.dumps(
                  {k: v for k, v in counts["capi typing read"].items() if v})
              + f"; am_save {save_s:.6f} s, {len(data)} bytes, (u)'s session-typed "
              f"save byte for byte on {card}", flush=True)

        # the compared prefix through per-call shim.call dispatch
        h = shim.call("create", U_ACTOR)[0][1]
        t = shim.call("put_object", h, "_root", "text", 2)[0][1]
        shim.call("commit", h, "")
        t0 = time.perf_counter()
        for i, (pos, ndel, *chars) in enumerate(edits[:U_COMPARE_EDITS]):
            shim.call("splice_text", h, t, pos, ndel, "".join(chars))
            if i % U_COMMIT_EVERY == U_COMMIT_EVERY - 1:
                shim.call("commit", h, "")
        shim.call("commit", h, "")
        call_s = time.perf_counter() - t0
        data = shim.call("save", h)[0][1]
        shim.call("free", h)
        if data != CAPI_INPUT["prefix"]:
            raise AssertionError("capi: the per-call shim's save of the prefix differs "
                                 "from the sessions' in (u)")
        print(f"capi typing (v): the first {U_COMPARE_EDITS} edits through per-call "
              f"shim.call('splice_text', ...) in {call_s:.6f} s, "
              f"{U_COMPARE_EDITS / call_s:.1f} edits/s, against the C cache's "
              f"{c_rate:.1f}; save (u)'s byte for byte", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"capi (v): the phase took {time.perf_counter() - t_phase:.3f} s on {card}",
          flush=True)
    return counts


def cold_open_paths(card: str, device) -> dict:
    """(j) the three fan-ins opened cold from images; releases them."""
    counts = {f"{name} cold open": cold_open(name, card, device) for name in COLD_ORDER}
    FANINS.clear()
    return counts


def check_reference_fault(device) -> None:
    """(d) Two map puts whose prop ids the JAX package's packed key merges
    (prop 64 + 4 needs more than ceil_log2(16 + 5) bits): the packed
    transport and the condensed merge give the dict path's winners and
    conflicts (the JAX package's merge_kernel_condensed(32, 16) does not)."""
    import numpy as np

    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import merge_columns, merge_kernel_condensed
    from automerge_tpu_torch.ops.oplog import pad_columns

    cols = {
        "action": np.array([1, 1], np.int32), "insert": np.zeros(2, bool),
        "prop": np.array([64, 0], np.int32), "elem_ref": np.array([-2, -2], np.int32),
        "obj_dense": np.array([0, 1], np.int32), "value_tag": np.array([4, 4], np.int32),
        "value_i32": np.zeros(2, np.int32), "width": np.ones(2, np.int32),
        "covered": np.ones(2, bool), "pred_src": np.zeros(0, np.int32),
        "pred_tgt": np.zeros(0, np.int32),
    }
    kw = dict(fetch=DeviceDoc.READ_FETCH, n_objs=2, n_props=None, device=device)
    d = merge_columns(dict(cols), **kw)
    p = merge_columns(dict(cols), transport="packed", **kw)
    c = columns_from_numpy(pad_columns(dict(cols, aorder=np.zeros(0, np.int32)), 2),
                           device)
    k = {name: v.cpu().numpy() for name, v in merge_kernel_condensed(32)(c).items()}
    got = {name: (list(r["winner"][:2]), list(r["conflicts"][:2]))
           for name, r in (("dict", d), ("packed", p), ("condensed", k))}
    if any(v != ([0, 1], [1, 1]) for v in got.values()):
        raise AssertionError(f"reference-fault input: winners, conflicts {got}")
    print("reference-fault input (props 64 and 0, P = 16): packed == condensed "
          "(rcap 32) == dict, winners [0, 1], conflicts [1, 1]",
          flush=True)


# (i) the record store's hot set: many documents drained at once
SERVE_DOCS, SERVE_CYCLES, SERVE_OPS, SERVE_BALLAST = 128, 16, 40, 8192
SERVE_PER_LAUNCH = 32  # documents a packed launch (a)
SERVE_BURST = (0, 8, 4096)  # document 0 types 4,096 characters in cycle 8
# The whale share. At these sizes the reference's 0.5 never peels: a whale
# needs more dirty rows than the other 31 documents of its launch together
# (11,625 in cycle 8) while staying under DIRTY_FRACTION_LIMIT of its own
# log (at most 8,194 rows beside the 8,192-character archive).
SERVE_FALLBACK = 0.25


def _diff_counts(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _add_counts(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def check_serve_equal(name: str, docs, want, cycle: int) -> None:
    """Every document of ``docs`` equals its twin in ``want`` (the
    per-document drain) on the READ_FETCH arrays, bit for bit."""
    import numpy as np

    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    for i, (a, b) in enumerate(zip(docs, want)):
        n = b.log.n
        if (a.log.n, a.log.n_objs) != (n, b.log.n_objs):
            raise AssertionError(f"{name} cycle {cycle} document {i}: log size differs")
        for k in DeviceDoc.READ_FETCH:
            cut = b.log.n_objs + 2 if k.startswith("obj_") else n
            if not np.array_equal(np.asarray(a.res[k])[:cut], np.asarray(b.res[k])[:cut]):
                raise AssertionError(f"{name} cycle {cycle} document {i}: {k} differs "
                                     f"from its own apply_batches")


def check_merges(name: str, counts: dict, merges: int) -> None:
    """Launches of ``merges`` run-native merges: linearize LAUNCHES each,
    succ_vis and forest 2, the winners 2 (scatter) or 3 (sort), at least
    one expand_runs and one radix_sort; nothing of another path."""
    from automerge_tpu_torch.kernels.linearize import LAUNCHES

    want = {"linearize": LAUNCHES * merges, "succ_vis": SV_LAUNCHES * merges,
            "forest": FOREST_LAUNCHES * merges}
    got = {k: counts[k] for k in want}
    winners = counts["scatter_winners"] // SW_LAUNCHES + counts["sort_winners"] // SO_LAUNCHES
    if got != want or winners != merges or counts["expand_runs"] < merges \
            or counts["radix_sort"] < merges:
        raise AssertionError(f"{name}: launches {json.dumps(counts)} are not those of "
                             f"{merges} merges")
    stray = [k for k in TRANSPORT_ONLY + SHARDED_ALL[:3] + SHARDED_CONDENSED
             + ("linearize_condensed",) if counts[k]]
    if stray:
        raise AssertionError(f"{name}: kernels launched that must not be: {stray}")


def cross_doc_paths(card: str, device):
    """(i) The cross-document served drain: SERVE_DOCS serve-shaped
    documents (``workload.serve_workload``), SERVE_CYCLES cycles of one
    change a document, built three times from the same bytes and drained
    (a) by ``apply_cross_doc`` in packed launches of SERVE_PER_LAUNCH
    documents, pipelined, (b) by each document's own ``apply_batches``,
    (c) by a ``CrossDocBatcher`` fed by one thread a document (holding its
    document's lock), in turns each cycle. Returns (launch counts by path,
    one packed super-batch's spec for the kernel report)."""
    import threading

    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import merge_columns
    from automerge_tpu_torch.ops.oplog import pad_columns

    doc0, cycle0, n0 = SERVE_BURST
    t_phase = t0 = time.perf_counter()
    base, deltas, texts = W.serve_workload(
        SERVE_DOCS, SERVE_CYCLES, SERVE_OPS, SERVE_BALLAST, burst={(doc0, cycle0): n0})
    print(f"cross-doc served workload: {SERVE_DOCS} documents (ballast "
          f"{SERVE_BALLAST}), {SERVE_CYCLES} cycles of {SERVE_OPS} characters, "
          f"document {doc0} types {n0} in cycle {cycle0}; "
          f"{time.perf_counter() - t0:.3f} s to generate and encode", flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    docs = {p: [DeviceDoc.merge([base], device=device) for _ in range(SERVE_DOCS)]
            for p in "abc"}
    torch.cuda.synchronize()
    base_counts = kernels.launch_counts()
    print(f"cross-doc served: {3 * SERVE_DOCS} bases resident on {card} in "
          f"{time.perf_counter() - t0:.3f} s, launches {json.dumps(base_counts)}",
          flush=True)
    check_merges("cross-doc base", base_counts, 3 * SERVE_DOCS)
    # (d), (e): the bases written as ARSN images and opened cold on the card
    from automerge_tpu_torch.ops import compressed as C
    from automerge_tpu_torch.ops.oplog import OpLog
    from automerge_tpu_torch.storage import runsnap as R
    from automerge_tpu_torch.storage.change import parse_change

    gc.collect()
    kernels.reset_launches()
    t0 = time.perf_counter()
    images = []
    for _ in range(2 * SERVE_DOCS):
        ch = parse_change(base)[0]
        images.append(R.encode_snapshot(OpLog.from_changes([ch]), [ch.hash]))
    t1 = time.perf_counter()
    cold = [DeviceDoc.resolve(R.parse(data).to_oplog(), device=device) for data in images]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    docs["d"], docs["e"] = cold[:SERVE_DOCS], cold[SERVE_DOCS:]
    cold_base_counts = kernels.launch_counts()
    check_merges("cross-doc cold base", cold_base_counts, 2 * SERVE_DOCS)
    if any(d.audit_columns() for d in cold):
        raise AssertionError("cross-doc cold base: an image differs from its columns")
    check_serve_equal("cross-doc cold base (d)", docs["d"], docs["b"], -1)
    check_serve_equal("cross-doc cold base (e)", docs["e"], docs["b"], -1)
    print(f"cross-doc served: {2 * SERVE_DOCS} bases written as images ({len(images[0])} "
          f"bytes each, the chunk {len(base)}) in {t1 - t0:.3f} s and opened cold on "
          f"{card} in {t2 - t1:.3f} s, equal to the change-built bases; launches "
          f"{json.dumps(cold_base_counts)}", flush=True)

    generations = []

    class NotingBatcher(B.CrossDocBatcher):
        def _flush(self, gen):
            generations.append(len(gen.subs) + len(gen.stages))
            super()._flush(gen)

    batcher = NotingBatcher(mode="1", window_ms=1000.0, max_docs=SERVE_PER_LAUNCH,
                            fallback_ratio=SERVE_FALLBACK, device=device)
    locks = [threading.Lock() for _ in range(SERVE_DOCS)]

    # one cycle's packed super-batches, held against the plain CPU merge
    check_cycle = 1
    captured, launch_rows = [], []
    dispatch, collect = B._dispatch_packed, B._collect_packed

    def noting_dispatch(cols, n_objs, n_props, *a, **k):
        handle = dispatch(cols, n_objs, n_props, *a, **k)
        launch_rows.append((handle["useful"], handle["P"]))
        if capture[0]:
            handle["check"] = (pad_columns(cols, n_objs), n_objs, n_props)
        return handle

    def noting_collect(handle, *a, **k):
        res = collect(handle, *a, **k)
        if "check" in handle:
            captured.append((handle["check"], res))
        return res

    capture = [False]
    drains = "abcde"
    totals = {p: {} for p in drains}
    stats = {p: dict.fromkeys(B.stats(), 0) for p in drains}
    seconds = {p: [] for p in drains}
    gcs = {p: 0.0 for p in drains}
    ovc = {p: 0 for p in drains}  # rows joined over the id runs
    phases = {"a": {}, "b": {}, "d": {}, "e": {}}
    whales = {"a": [], "d": []}
    per_cycle_launches = {p: [] for p in drains}

    def packed_drain(p):
        def run(c):
            work = [(d, [[deltas[i][c]]]) for i, d in enumerate(docs[p])]
            out = B.apply_cross_doc(work, max_docs_per_launch=SERVE_PER_LAUNCH,
                                    fallback_ratio=SERVE_FALLBACK, device=device,
                                    phases=phases[p])
            if out["applied"] != SERVE_DOCS:
                raise AssertionError(f"cross-doc ({p}) cycle {c}: applied {out}")
        return run

    def per_doc_drain(p):
        def run(c):
            for i, d in enumerate(docs[p]):
                d.apply_batches([[deltas[i][c]]], phases[p])
        return run

    def run_c(c):
        errs = []
        barrier = threading.Barrier(SERVE_DOCS)

        def worker(i):
            try:
                barrier.wait()
                with locks[i]:
                    batcher.apply(docs["c"][i], [[deltas[i][c]]])
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(SERVE_DOCS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]

    runs = {"a": packed_drain("a"), "b": per_doc_drain("b"), "c": run_c,
            "d": packed_drain("d"), "e": per_doc_drain("e")}
    B._dispatch_packed, B._collect_packed = noting_dispatch, noting_collect
    try:
        for c in range(SERVE_CYCLES):
            order = drains[c % 5:] + drains[:c % 5]
            for p in order:
                gc.collect()
                kernels.reset_launches()
                B.reset_stats()
                C.reset_stats()
                capture[0] = p == "a" and c == check_cycle
                with gc_pauses() as pauses:
                    t0 = time.perf_counter()
                    runs[p](c)
                    torch.cuda.synchronize()
                    seconds[p].append(time.perf_counter() - t0)
                gcs[p] += sum(s for _, s in pauses)
                ovc[p] += C.stats()["ovc_join"]
                counts = kernels.launch_counts()
                _add_counts(totals[p], counts)
                s = B.stats()
                _add_counts(stats[p], s)
                merges = (SERVE_DOCS if p in "be"
                          else s["launches"] + s["batched_fallback"])
                check_merges(f"cross-doc ({p}) cycle {c}", counts, merges)
                per_cycle_launches[p].append(s["launches"])
                if p in "ad":
                    whales[p].append(s["batched_fallback"])
                    if s["launches"] != SERVE_DOCS // SERVE_PER_LAUNCH:
                        raise AssertionError(f"cross-doc ({p}) cycle {c}: "
                                             f"{s['launches']} packed launches")
            for p in "acde":
                check_serve_equal(f"cross-doc ({p})", docs[p], docs["b"], c)
    finally:
        B._dispatch_packed, B._collect_packed = dispatch, collect

    # checks of the whole drain
    for p in "acd":
        s = stats[p]
        if s["batched_error"] or s["scalar_docs"] or s["demoted_docs"] \
                or s["extract_error"] or s["vectorized_docs"] != SERVE_DOCS * SERVE_CYCLES:
            raise AssertionError(f"cross-doc ({p}): {json.dumps(s)}: an error, or an "
                                 "admitted document on the scalar path")
    if whales["a"][cycle0] < 1 or whales["d"] != whales["a"]:
        raise AssertionError(f"cross-doc (a), (d): whales by cycle {whales}: none in "
                             f"cycle {cycle0}, or not the same")
    for p in "de":
        bad = [i for i, d in enumerate(docs[p]) if d.audit_columns()]
        if bad:
            raise AssertionError(f"cross-doc ({p}): documents whose image differs from "
                                 f"their columns: {bad}")
        if ovc[p] <= 0:
            raise AssertionError(f"cross-doc ({p}): no row joined over the id runs")
    if len(generations) != SERVE_CYCLES * SERVE_DOCS // SERVE_PER_LAUNCH \
            or set(generations) != {SERVE_PER_LAUNCH} \
            or per_cycle_launches["c"] != [2 * SERVE_DOCS // SERVE_PER_LAUNCH] * SERVE_CYCLES:
        raise AssertionError(f"cross-doc (c): generations {generations}, packed launches "
                             f"a cycle {per_cycle_launches['c']}: not two half-launches "
                             f"a generation of {SERVE_PER_LAUNCH}")
    for p in drains:
        for i, d in enumerate(docs[p]):
            if d.text(W.SERVE_LIVE) != texts[i] \
                    or d.text(W.SERVE_ARCHIVE) != "x" * SERVE_BALLAST:
                raise AssertionError(f"cross-doc ({p}) document {i}: live or archive "
                                     "differs from the generator's")
    if len(captured) != SERVE_DOCS // SERVE_PER_LAUNCH:
        raise AssertionError(f"cross-doc: {len(captured)} packed launches captured")
    for (cols, n_objs, n_props), res in captured:
        plain = merge_columns(dict(cols), fetch=DeviceDoc.READ_FETCH, n_objs=n_objs,
                              n_props=n_props, device="cpu")
        for k in DeviceDoc.READ_FETCH:
            if not np.array_equal(res[k], np.asarray(plain[k])):
                raise AssertionError(f"cross-doc packed launch (P {len(cols['action'])}):"
                                     f" {k} differs from the plain CPU merge")
    print(f"cross-doc served: (a) and (c) equal (b) on READ_FETCH after every cycle; "
          f"live and archive as the generator's; cycle {check_cycle}'s "
          f"{len(captured)} packed super-batches (P "
          f"{[len(c[0]['action']) for c, _ in captured]}) equal the plain CPU merge",
          flush=True)

    merges_a = sum(per_cycle_launches["a"]) + sum(whales["a"])
    merges_b = SERVE_DOCS * SERVE_CYCLES
    kinds = {"a": "packed", "b": "per-doc", "c": "batcher",
             "d": "packed, opened from images", "e": "per-doc, opened from images"}
    for p in drains:
        sec = seconds[p]
        print(f"cross-doc ({p}) {kinds[p]}: "
              f"per cycle p50 {statistics.median(sec):.6f} s max {max(sec):.6f} s, "
              f"drain {sum(sec):.6f} s, gc {gcs[p]:.6f} s, rows joined over the id "
              f"runs {ovc[p]} on {card}", flush=True)
    print(f"cross-doc served from images: (d) and (e) equal (b) on READ_FETCH after "
          f"every cycle; audit_columns() == [] for all {2 * SERVE_DOCS}; offset-value-"
          f"coded joins: (d) staged splice {ovc['d']} rows, (e) per-document "
          f"{ovc['e']} rows", flush=True)
    useful = [u for u, _ in launch_rows]
    padded = [P - u for u, P in launch_rows]
    print(f"cross-doc packed launches: {len(launch_rows)} in (a) and (c), useful rows "
          f"a launch p50 {statistics.median(useful)} max {max(useful)}, padded rows "
          f"p50 {statistics.median(padded)} max {max(padded)}", flush=True)
    print("cross-doc (a) stages_s " + json.dumps(
        {k: round(v, 6) for k, v in phases["a"].items()}), flush=True)
    print("cross-doc (b) stages_s " + json.dumps(
        {k: round(v, 6) for k, v in phases["b"].items() if k != "batches"}), flush=True)
    print("cross-doc (d) stages_s " + json.dumps(
        {k: round(v, 6) for k, v in phases["d"].items()}), flush=True)
    def launched(p):
        return json.dumps({k: v for k, v in totals[p].items() if v})

    print(f"cross-doc launches: (a) {merges_a} merges ({sum(per_cycle_launches['a'])} "
          f"packed, whales by cycle {whales['a']}) {launched('a')}; (b) {merges_b} merges "
          f"{launched('b')}; (c) {sum(per_cycle_launches['c'])} packed + "
          f"{stats['c']['batched_fallback']} whales {launched('c')}; (d) "
          f"{launched('d')}; (e) {launched('e')}", flush=True)
    print(f"cross-doc served: the phase took {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    (cols, n_objs, n_props), _ = captured[0]
    counts = {"cross-doc": totals["a"], "cross-doc per-doc": totals["b"],
              "cross-doc batcher": totals["c"], "cross-doc base": base_counts,
              "cross-doc cold": totals["d"], "cross-doc cold per-doc": totals["e"],
              "cross-doc cold base": cold_base_counts}
    return counts, (cols, n_objs, n_props)


def check_served_subset(last, device) -> None:
    """One served batch's subset columns: the whole merge on the card
    equals the plain CPU path on every output, exactly."""
    import numpy as np

    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_kernel

    cols, n_objs, n_props = last
    gpu = merge_kernel(columns_from_numpy(cols, device), n_objs, n_props)
    cpu = merge_kernel(columns_from_numpy(cols, "cpu"), n_objs, n_props)
    for k in ALL_OUTPUTS:
        if not np.array_equal(gpu[k].cpu().numpy(), cpu[k].numpy()):
            raise AssertionError(f"served subset: {k} differs between cuda and cpu")
    print(f"served subset (P {len(cols['action'])}, {n_objs} objects, prop ids "
          f"to {int(cols['prop'].max())}): cuda == cpu on all outputs", flush=True)


def expand_library(W, C, n: int):
    """torch.searchsorted and a gather: the decode of one stack in
    PyTorch calls (the yardstick of expand_runs)."""
    K, rcap = W.shape
    i = torch.arange(n, dtype=torch.int32, device=W.device).expand(K, n).contiguous()
    return lambda: torch.gather(W, 1, torch.searchsorted(C, i, right=True)
                                .clamp_(max=rcap - 1))


def expand_rows(stacks):
    """expand_runs rows for stacks of run tables: [(W, C, S or None, n,
    bools, tag)]."""
    from automerge_tpu_torch.kernels import expand_runs as E

    rows = []
    for W, C, S, n, bools, tag in stacks:
        args = (W, C, S, n, bools)
        rows.append(("expand_runs", E.expand_runs, E.expand_runs_plain, args,
                     E.expand_runs(*args), expand_library(W, C, n), tag))
    return rows


def resolve_rows(c, scatter_geom):
    """succ_vis, the winners (scatter_winners over ``scatter_geom`` =
    (n_objs2, n_props), sort_winners for None), forest and its
    radix_sort on column tensors ``c``, as a merge runs them: (rows,
    forest outputs). sort_winners and radix_sort are timed beside
    torch.sort of the same keys."""
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import scatter_winners as SW
    from automerge_tpu_torch.kernels import sort_winners as SO
    from automerge_tpu_torch.kernels import succ_vis as SV

    sv_in = (c["action"], c["value_tag"], c["value_i32"], c["covered"],
             c["pred_src"], c["pred_tgt"])
    before = SV.succ_vis.launches
    sv = SV.succ_vis(*sv_in)
    check_call_launches("succ_vis", SV.succ_vis.launches - before, SV_LAUNCHES)
    rows = [("succ_vis", SV.succ_vis, SV.succ_vis_plain, sv_in, sv, None,
             f"{SV_LAUNCHES} launches a call")]
    win_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
              c["width"], sv[3])
    if scatter_geom is not None:
        sw_in = win_in + scatter_geom
        before = SW.scatter_winners.launches
        sw = SW.scatter_winners(*sw_in)
        check_call_launches("scatter_winners",
                            SW.scatter_winners.launches - before, SW_LAUNCHES)
        rows.append(("scatter_winners", SW.scatter_winners,
                     SW.scatter_winners_plain, sw_in, sw, None,
                     f"{SW_LAUNCHES} launches a call"))
    else:
        keys = group_keys(*win_in[:5])
        rows.append(("sort_winners", SO.sort_winners, SO.sort_winners_plain,
                     win_in, SO.sort_winners(*win_in), lambda: torch.sort(keys), ""))
    fo_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    before = F.forest.launches
    fo = F.forest(*fo_in)
    check_call_launches("forest", F.forest.launches - before, FOREST_LAUNCHES)
    # the forest sorts its element rows' keys alone, compacted to the
    # front of a P-key buffer, by a count that stays on the card
    P = c["action"].numel()
    elem = F.element_keys(fo[0], fo[1])
    n = elem.numel()
    buf = torch.zeros(P, dtype=torch.int64, device=c["action"].device)
    buf[:n] = elem
    count = torch.tensor([n], dtype=torch.int32, device=buf.device)
    tag = f"{n} of {P} rows' keys sorted"
    rows.append(("forest", F.forest, F.forest_plain, fo_in, fo, None,
                 f"{FOREST_LAUNCHES} launches a call, {tag}"))
    digits = F.sibling_digits(P)
    rs_in = (buf, digits, count, n)
    rows.append(("radix_sort", sorted_prefix, sorted_prefix_plain, rs_in,
                 (sorted_prefix(*rs_in),), lambda: torch.sort(elem), tag))
    return rows, fo


SV_LAUNCHES = 2  # succ_vis: row pass, edge pass
SP_LAUNCHES = 1  # succ_partial: edge pass (one memset before)
SW_LAUNCHES = 2  # scatter_winners: scatter, gather
SO_LAUNCHES = 3  # sort_winners: fill, insert, gather
FOREST_LAUNCHES = 2  # forest: links, finish (its radix_sort counts apart)


def sorted_prefix(keys, digits, count, n: int):
    """radix_sort over a device-side count, as the forest calls it: the
    sorted first ``n`` keys (``n`` = ``count``, known here)."""
    from automerge_tpu_torch.kernels import radix_sort as RS

    return RS.radix_sort(keys, digits, count)[:n]


def sorted_prefix_plain(keys, digits, count, n: int):
    from automerge_tpu_torch.kernels import radix_sort as RS

    return RS.radix_sort_plain(keys, digits, count)[:n]


def path_kernels(cols, n_objs: int, n_props: int, device):
    """The kernels of one path's run-native merge run on its padded
    columns as the merge runs them: [(name, kernel, plain, args, out,
    library, tag)], expand_runs once for each stack of run tables (its
    tag: the stack's length and form)."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.ops.merge import (
        scatter_geom_key, scatter_geometry_ok, stage_cols_run_native,
    )

    _, stacks, plan = stage_cols_run_native(cols, device)
    rows = expand_rows([
        (arrs[0], arrs[1], arrs[2] if cls == "delta" else None, n, bools,
         f"n={n} {cls} K={len(names)} rcap={rcap}")
        for (n, rcap, cls, names, bools), arrs in zip(plan, stacks)])
    c = columns_from_numpy(cols, device)
    geom = (scatter_geom_key(n_objs, n_props)
            if scatter_geometry_ok(c["action"].numel(), n_objs, n_props) else None)
    core, fo = resolve_rows(c, geom)
    rows += core
    li_in = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"])
    before = L.linearize.launches
    li = L.linearize(*li_in)
    check_call_launches("linearize", L.linearize.launches - before, L.LAUNCHES)
    rows.append(("linearize", L.linearize, L.linearize_plain, li_in, (li,), None,
                 f"{L.LAUNCHES} launches a call"))
    return rows


def eager_kernels(cols, n_objs: int, n_props: int, device):
    """expand_runs at each stack of run tables the eager-expansion staging
    (``staging="expand"``, K9) makes of one path's padded columns, as
    ``stage_cols_device`` runs it: one stack per column length, always
    the delta form, bool columns among the int32 ones."""
    import numpy as np

    from automerge_tpu_torch.ops.merge import _encode_columns, _stack

    _, groups = _encode_columns({k: np.asarray(v) for k, v in cols.items()},
                                run_native=False)
    stacks = []
    for n, group in groups.items():
        rcap, *arrs = _stack(n, group)
        W, C, S = (torch.from_numpy(a).to(device) for a in arrs)
        bools = tuple(b for _, _, b in group)
        stacks.append((W, C, S, n, bools, f"n={n} delta K={len(group)} "
                       f"rcap={rcap} bool columns {sum(bools)}"))
    return expand_rows(stacks)


def packed_kernels(cols, n_objs: int, n_props: int, device, fetch=None):
    """The packed transport's own kernels on one path's padded columns, as
    ``DeviceDoc.resolve(..., transport="packed")`` runs them: expand_runs
    at its row and edge stacks, unpack_flags, emit_packed of ``fetch``
    (READ_FETCH unless given)."""
    from automerge_tpu_torch.kernels import emit_packed as EP
    from automerge_tpu_torch.kernels import expand_runs as E
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import (
        _capacity, _unpack_transport, encode_transport, merge_kernel,
    )

    key, arrays = encode_transport(cols)
    a = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    P, Q = len(cols["action"]), len(cols["pred_src"])
    stacks = [(a[f"w{g}"], a[f"c{g}"], a[f"s{g}"], n, (False,) * len(names),
               f"packed {g} n={n} K={len(names)} rcap={a[f'w{g}'].shape[1]}")
              for g, names, n in (("P", key[0], P), ("Q", key[2], Q)) if names]
    rows = expand_rows(stacks)
    if "flags" in key[0]:
        flags = rows[0][4][key[0].index("flags")]
    else:
        flags = a["plainP"][key[1].index("flags")]
    rows.append(("unpack_flags", E.unpack_flags, E.unpack_flags_plain, (flags,),
                 E.unpack_flags(flags), None, ""))
    core = merge_kernel(_unpack_transport(key, a, P, Q), n_objs, n_props)
    em_in = (core, fetch or DeviceDoc.READ_FETCH, min(_capacity(n_objs + 2, 16), P + 2))
    rows.append(("emit_packed", EP.emit_packed, EP.emit_packed_plain, em_in,
                 (EP.emit_packed(*em_in),), None, ""))
    return rows


def view_kernels(cols, n_objs: int, n_props: int, device):
    """The kernels a historical view's merge runs on a clock mask with
    false rows, at its padded columns: expand_runs at each stack of run
    tables the run-native staging makes, then succ_vis."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import succ_vis as SV
    from automerge_tpu_torch.ops.merge import stage_cols_run_native

    _, stacks, plan = stage_cols_run_native(cols, device)
    rows = expand_rows([
        (arrs[0], arrs[1], arrs[2] if cls == "delta" else None, n, bools,
         f"n={n} {cls} K={len(names)} rcap={rcap}")
        for (n, rcap, cls, names, bools), arrs in zip(plan, stacks)])
    c = columns_from_numpy(cols, device)
    sv_in = (c["action"], c["value_tag"], c["value_i32"], c["covered"],
             c["pred_src"], c["pred_tgt"])
    before = SV.succ_vis.launches
    sv = SV.succ_vis(*sv_in)
    check_call_launches("succ_vis", SV.succ_vis.launches - before, SV_LAUNCHES)
    rows.append(("succ_vis", SV.succ_vis, SV.succ_vis_plain, sv_in, sv, None,
                 f"{SV_LAUNCHES} launches a call, "
                 f"{int(c['covered'].sum())} of {c['covered'].numel()} rows covered"))
    return rows


def condensed_kernels(cols, n_objs: int, n_props: int, device, rcap: int):
    """merge_kernel_condensed's kernels on one path's padded columns (with
    the actor order), as it runs them: succ_vis, sort_winners, forest,
    radix_sort, then linearize_condensed at ``rcap``."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import linearize_condensed as LC

    c = columns_from_numpy(cols, device)
    rows, fo = resolve_rows(c, None)
    lc_in = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"], c["aorder"],
             rcap)
    before = LC.linearize_condensed.launches
    lc = LC.linearize_condensed(*lc_in)
    check_call_launches("linearize_condensed",
                        LC.linearize_condensed.launches - before, LC.LAUNCHES)
    rows.append(("linearize_condensed", LC.linearize_condensed,
                 LC.linearize_condensed_plain, lc_in, (lc,), None,
                 f"rcap={rcap}"))
    return rows


def sharded_kernels(cols, n_objs: int, n_props: int, device, linearize: str,
                    shards: int = MESH_SHARDS):
    """The sharded merge's kernels on one path's padded columns at one
    shard's shapes (a mesh of ``shards`` on one card), as it runs them:
    succ_partial on shard 0's pred slice, mesh_reduce folding the
    shards' accumulators where they lie (and, past the scatter gate,
    their win tables), visibility, the row-range winners at shard 0, then
    the ``linearize`` arm's kernels: a doubling round at one shard's slice
    of the state (the loops run to their end in between), and the
    condensed expansion over all rows in one launch."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import collectives as CK
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.kernels import scatter_winners as SW
    from automerge_tpu_torch.kernels import sharded as SH
    from automerge_tpu_torch.kernels import succ_vis as SV
    from automerge_tpu_torch.parallel import sharding as PS

    n = shards
    c = columns_from_numpy({k: cols[k] for k in PS.COLUMN_SPECS}, device)
    P, Q = c["action"].numel(), c["pred_src"].numel()
    Pl, Ql = P // n, Q // n
    assert P % n == 0 and Q % n == 0, (P, Q)

    def succ_in(i):
        return (c["action"], c["value_i32"], c["covered"],
                c["pred_src"][i * Ql:(i + 1) * Ql].contiguous(),
                c["pred_tgt"][i * Ql:(i + 1) * Ql].contiguous())

    before = SV.succ_partial.launches
    accs = [SV.succ_partial(*succ_in(i)) for i in range(n)]
    check_call_launches(f"succ_partial, {n} calls",
                        SV.succ_partial.launches - before, n * SP_LAUNCHES)
    rows = [("succ_partial", SV.succ_partial, SV.succ_partial_plain, succ_in(0),
             (accs[0],), None, f"shard 0, {SP_LAUNCHES} launch a call")]
    acc = CK.mesh_reduce(accs, "sum")
    rows.append(("mesh_reduce", CK.mesh_reduce, CK.mesh_reduce_plain, (accs, "sum"),
                 (acc,), lambda: torch.stack(accs).sum(0, dtype=torch.int32),
                 f"psum {n} x [3, P], {CK.passes(n)} launch(es)"))
    vis_in = (c["action"], c["value_tag"], c["covered"], acc[0], acc[1])
    visible = SV.visibility(*vis_in)
    rows.append(("visibility", SV.visibility, SV.visibility_plain, vis_in,
                 (visible,), None, ""))
    if PS.sharded_gate(P, n_objs + 2, n_props):
        geom = (n_objs + 2, max(n_props, 1))

        def part_in(i):
            return (c["action"], c["insert"], c["elem_ref"], c["obj_dense"],
                    c["prop"], visible, i * Pl, Pl, *geom)

        tables = [SW.winners_partial(*part_in(i)) for i in range(n)]
        rows.append(("winners_partial", SW.winners_partial,
                     SW.winners_partial_plain, part_in(0), (tables[0],), None,
                     "shard 0"))
        wins = [t[0] for t in tables]
        win = CK.mesh_reduce(wins, "max")
        rows.append(("mesh_reduce", CK.mesh_reduce, CK.mesh_reduce_plain,
                     (wins, "max"), (win,), lambda: torch.stack(wins).amax(0),
                     f"pmax {n} x [G], {CK.passes(n)} launch(es)"))
        cnt = CK.mesh_reduce([t[1] for t in tables], "sum")
        wg_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
                 c["width"], win, cnt, 0, Pl, *geom)
        rows.append(("winners_gather", SW.winners_gather, SW.winners_gather_plain,
                     wg_in, SW.winners_gather(*wg_in), None, "shard 0"))
    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])

    def doubling(loop, state, length, rounds, tag):
        """A round of the range kernel at shard 1's slice, then the whole
        loop over all nodes by its rounds entry (``rounds`` launches), as
        a mesh of one card runs it."""
        (step, plain), (whole, whole_plain) = loop
        args = (*state, length, length)
        rows.append((step.__name__, step, plain, args, step(*args), None,
                     f"{tag} shard 1"))
        args = (*state, rounds)
        before = whole.launches
        out = whole(*args)
        check_call_launches(whole.__name__, whole.launches - before, rounds)
        rows.append((whole.__name__, whole, whole_plain, args, out, None,
                     f"{tag}, {rounds} rounds"))
        return out

    thread = ((L.linearize_thread, L.linearize_thread_plain),
              (L.linearize_thread_rounds, L.linearize_thread_rounds_plain))
    rank = ((L.linearize_rank, L.linearize_rank_plain),
            (L.linearize_rank_rounds, L.linearize_rank_rounds_plain))
    rank_from_thread = ((L.linearize_rank_first, L.linearize_rank_first_plain),
                        (L.linearize_rank_from_thread,
                         L.linearize_rank_from_thread_plain))

    if linearize == "rows":
        El = Pl + 1
        li_in = (fo[2], fo[3], fo[0], c["elem_ref"], n * El)
        st = L.linearize_init(*li_in)
        rows.append(("linearize_init", L.linearize_init, L.linearize_init_plain,
                     li_in, st, None, f"Epad={n * El}"))
        ans = doubling(thread, st[:3], El, L.rounds(P), f"El={El}")[0]
        # the rank loop from the thread loop's answers, held against the
        # reference's init then rounds (the plain composition)
        dist = doubling(rank_from_thread, (st[3], ans, P), El, L.rounds(P),
                        f"El={El}")[0]
        # a later round over distinct cards: the range round at shard 1's
        # slice of the state the first round gives
        first = L.linearize_rank_first(st[3], ans, P, 0, n * El)
        rk_in = (*first, El, El)
        rows.append(("linearize_rank", L.linearize_rank, L.linearize_rank_plain,
                     rk_in, L.linearize_rank(*rk_in), None,
                     f"El={El} shard 1, round 2"))
        fi_in = (fo[2], fo[0], c["obj_dense"], dist, 0, P)
        rows.append(("linearize_final", L.linearize_final, L.linearize_final_plain,
                     fi_in, (L.linearize_final(*fi_in),), None, ""))
        return rows
    R2, cond_np = PS.condense_host(cols, n_objs + 2, n)
    Rl = R2 // n
    cond = {k: torch.from_numpy(v).to(device) for k, v in cond_np.items()}
    ci_in = (cond["centry"], cond["cpar"])
    ci = SH.cond_init(*ci_in)
    rows.append(("cond_init", SH.cond_init, SH.cond_init_plain, ci_in, ci, None,
                 f"R2={R2}"))
    rounds = L.ceil_log2(R2) + 1
    ans = doubling(thread, ci, Rl, rounds, f"R2={R2}")[0]
    cs_in = (cond["tail_ans"], ans, cond["chain_id"], cond["clen"])
    cs = SH.cond_succ(*cs_in)
    rows.append(("cond_succ", SH.cond_succ, SH.cond_succ_plain, cs_in, cs, None,
                 f"R2={R2}"))
    cdist = doubling(rank, cs, Rl, rounds, f"R2={R2}")[0]
    ce_in = (cond["chain_id"], cond["offset"], c["obj_dense"], c["insert"],
             c["action"], cond["start_chain"], cdist, 0, P)
    rows.append(("cond_expand", SH.cond_expand, SH.cond_expand_plain, ce_in,
                 (SH.cond_expand(*ce_in),), None, f"all {P} rows, one launch"))
    return rows


REPLACES = {
    "succ_vis": ("automerge_tpu/ops/merge.py:59", "succ_vis.cu"),
    "scatter_winners": ("automerge_tpu/ops/merge.py:595", "scatter_winners.cu"),
    "sort_winners": ("automerge_tpu/ops/merge.py:110", "sort_winners.cu"),
    "forest": ("automerge_tpu/ops/merge.py:551", "forest.cu"),
    "radix_sort": ("automerge_tpu/ops/merge.py:582", "radix_sort.cu"),
    "linearize": ("automerge_tpu/ops/merge.py:216", "linearize.cu"),
    "linearize_condensed": ("automerge_tpu/ops/merge.py:303",
                            "linearize_condensed.cu"),
    "expand_runs": ("automerge_tpu/ops/merge.py:993", "expand_runs.cu"),
    "unpack_flags": ("automerge_tpu/ops/merge.py:1143", "expand_runs.cu"),
    "emit_packed": ("automerge_tpu/ops/merge.py:1181", "emit_packed.cu"),
    "succ_partial": ("automerge_tpu/parallel/sharding.py:340", "succ_vis.cu"),
    "visibility": ("automerge_tpu/parallel/sharding.py:345", "succ_vis.cu"),
    "winners_partial": ("automerge_tpu/parallel/sharding.py:132",
                        "scatter_winners.cu"),
    "winners_gather": ("automerge_tpu/parallel/sharding.py:141",
                       "scatter_winners.cu"),
    "linearize_init": ("automerge_tpu/parallel/sharding.py:216", "linearize.cu"),
    "linearize_thread": ("automerge_tpu/parallel/sharding.py:218", "linearize.cu"),
    "linearize_rank": ("automerge_tpu/parallel/sharding.py:238", "linearize.cu"),
    "linearize_rank_first": ("automerge_tpu/parallel/sharding.py:232",
                             "linearize.cu"),
    "linearize_final": ("automerge_tpu/parallel/sharding.py:247", "linearize.cu"),
    "linearize_thread_rounds": ("automerge_tpu/parallel/sharding.py:218",
                                "linearize.cu"),
    "linearize_rank_rounds": ("automerge_tpu/parallel/sharding.py:238",
                              "linearize.cu"),
    "linearize_rank_from_thread": ("automerge_tpu/parallel/sharding.py:232",
                                   "linearize.cu"),
    "cond_init": ("automerge_tpu/parallel/sharding.py:283", "sharded.cu"),
    "cond_succ": ("automerge_tpu/parallel/sharding.py:300", "sharded.cu"),
    "cond_expand": ("automerge_tpu/parallel/sharding.py:320", "sharded.cu"),
    "mesh_reduce": ("automerge_tpu/parallel/sharding.py:139", "collectives.cu"),
}


# the kernels timed on the device as well (torch.profiler)
DEVICE_TIMED = ("expand_runs", "linearize", "linearize_condensed",
                "scatter_winners", "forest",
                "radix_sort", "succ_vis", "succ_partial", "visibility",
                "linearize_thread_rounds", "linearize_rank_rounds",
                "linearize_rank_from_thread", "mesh_reduce", "cond_expand",
                "emit_packed")
# the whole doubling loops (a rounds entry): also a round's mean
LOOP_ENTRIES = ("linearize_thread_rounds", "linearize_rank_rounds",
                "linearize_rank_from_thread")


def bound(name: str, args, out) -> tuple:
    """(the least ms the card could take for ``name`` on these inputs,
    "bytes" or "operations"): ``work`` over the memory rate and the
    int32 rate, the larger."""
    moved, ops = work(name, args, out)
    bounds = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
              "operations": ops / INT32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    return bounds[bound_by], bound_by


def measure(name, kern, plain, args, out, library, reps: int) -> dict:
    """One kernel at one path's shapes: its output against its plain
    version (raising unless equal), its bound and its times."""
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(out, want)
    bound_ms, bound_by = bound(name, args, out)
    m = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: kern(*args), reps),
        "plain_ms": cuda_ms(lambda: plain(*args), reps),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": cuda_ms(library, reps) if library else None,
    }
    if name in DEVICE_TIMED:
        m["device_ms"], m["device_kernels"] = device_ms(lambda: kern(*args), reps)
        if library:
            m["library_device_ms"] = device_ms(library, reps)[0]
    if name in LOOP_ENTRIES:
        rounds = args[-1]
        m["rounds"] = rounds
        m["bound_ms_a_round"] = bound_ms / rounds
        m["device_ms_a_round"] = (m["device_ms"] / rounds
                                  if m["device_ms"] is not None else None)
    return m


def expand_host_steps(W, C, S, n: int, bools, library, reps: int = 200) -> dict:
    """Host microseconds of one expand_runs call on the card, by the
    wrapper's steps (argument checks, the layout of the bool columns, the
    allocations, the stream handle, the C call that launches the kernel,
    the column views), the whole call, and the yardstick's two PyTorch
    calls: medians of ``reps`` calls, each timed alone, the card
    synchronised between calls so that no queue fills."""
    from automerge_tpu_torch.kernels import expand_runs as E
    from automerge_tpu_torch.kernels._args import on_cuda, stream

    K, _, bools = E._check(W, C, S, n, bools)
    bits, nb, order = E._layout(bools)
    ints, flags = E._outputs(K, nb, n, W.device)
    st = stream(W)
    return host_us({
        "checks": lambda: (E._check(W, C, S, n, bools),
                           on_cuda(W=W, C=C) if S is None else on_cuda(W=W, C=C, S=S)),
        "layout": lambda: E._layout(bools),
        "allocate": lambda: E._outputs(K, nb, n, W.device),
        "stream": lambda: stream(W),
        "launch": lambda: E._launch(W, C, S, n, bits, ints, flags, st),
        "views": lambda: E._columns(ints, flags, order),
        "whole call": lambda: E.expand_runs(W, C, S, n, bools),
        "yardstick (searchsorted + gather)": library,
    }, reps)


def succ_vis_host_steps(args, reps: int = 200) -> dict:
    """Host microseconds of one succ_vis call on the card, by the
    wrapper's steps (six ``expect`` calls and ``on_cuda``, the one
    allocation, the stream handle, the C call that launches the row and
    edge passes, the four views) and the whole call, as
    ``expand_host_steps`` times them."""
    from automerge_tpu_torch.kernels import succ_vis as SV
    from automerge_tpu_torch.kernels._args import stream

    P, dev = args[0].shape[0], args[0].device
    out = SV._output(P, dev)
    st = stream(args[0])
    return host_us({
        "checks": lambda: SV._check(*args),
        "allocate": lambda: SV._output(P, dev),
        "stream": lambda: stream(args[0]),
        "launch": lambda: SV._launch(*args, out, st),
        "views": lambda: SV._views(out, P),
        "whole call": lambda: SV.succ_vis(*args),
    }, reps)


def linearize_condensed_host_steps(args, reps: int = 200) -> dict:
    """Host microseconds of one linearize_condensed call on the card, by
    the wrapper's steps (six ``expect`` calls and ``on_cuda``, the three
    allocations, the stream handle, the C call that launches the memset
    and the eight kernels, the run count's readback after a launch: the
    device's time with it) and the whole call, as ``expand_host_steps``
    times them."""
    from automerge_tpu_torch.kernels import linearize_condensed as LC
    from automerge_tpu_torch.kernels._args import stream

    *cols, rcap = args
    P, dev = cols[2].shape[0], cols[2].device
    bufs = LC._buffers(P, rcap, dev)
    st = stream(cols[2])

    def launch_and_read():
        LC._launch(cols, rcap, *bufs, st)
        return int(bufs[0][0])

    return host_us({
        "checks": lambda: LC._check(*args),
        "allocate": lambda: LC._buffers(P, rcap, dev),
        "stream": lambda: stream(cols[2]),
        "launch": lambda: LC._launch(cols, rcap, *bufs, st),
        "launch and readback": launch_and_read,
        "whole call": lambda: LC.linearize_condensed(*args),
    }, reps)


def host_us(steps: dict, reps: int) -> dict:
    """{step: median host microseconds of ``reps`` calls}, each call
    timed alone, the card synchronised between calls so that no queue
    fills."""
    us = {}
    for name, fn in steps.items():
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        us[name] = statistics.median(times) * 1e6
    torch.cuda.synchronize()
    return us


# the wrappers timed on the host step by step, at the first path that
# runs them: name -> (its arguments, its yardstick) -> {step: µs}
HOST_STEPS = {
    "expand_runs": lambda args, library: expand_host_steps(*args, library),
    "succ_vis": lambda args, library: succ_vis_host_steps(args),
    "linearize_condensed": lambda args, library: linearize_condensed_host_steps(args),
}


def kernel_rows(path: str, spec, device):
    """The kernel rows of one path, by its name (see ``kernel_report``),
    on ``spec`` = (padded columns, n_objs, n_props, *caps)."""
    cols, n_objs, n_props, *caps = spec
    rows_of = (sharded_kernels if "sharded" in path else
               packed_kernels if path.endswith("packed") else
               view_kernels if path.endswith("view") else
               eager_kernels if path.endswith("expand") else
               condensed_kernels if path.endswith("condensed") else path_kernels)
    return rows_of(cols, n_objs, n_props, device, *caps)


def kernel_report(paths, by_path, device, reps: int):
    """Each kernel against its plain version at the shapes of every path
    that runs it (``paths``: name -> (padded columns, n_objs, n_props), and
    for a name ending in "condensed", the condensed merge's, its columns
    with the actor order and rcap after; a name ending in
    "packed" is the packed transport's, one ending in "expand" the
    eager-expansion staging's), and sort_winners past 2^20 rows. A kernel's top-level numbers are those of the first
    path that runs it; ``by_path`` has them all (expand_runs: by stack)."""
    from automerge_tpu_torch.kernels import sort_winners as SO

    report = {}
    host_steps_done = set()
    for path, spec in paths.items():
        for name, kern, plain, args, out, library, tag in kernel_rows(
                path, spec, device):
            m = {"P": len(spec[0]["action"]),
                 **measure(name, kern, plain, args, out, library, reps)}
            m["launches"] = by_path[path][name]
            where = f"{path} {tag}".strip()
            if name in HOST_STEPS and name not in host_steps_done:
                host_steps_done.add(name)
                us = HOST_STEPS[name](args, library)
                print(f"{where}: {name} host us by step {json.dumps(us)}",
                      flush=True)
            print(f"{where}: {name} equal to its plain version, "
                  f"{json.dumps(m)}", flush=True)
            if name not in report:
                replaces, source = REPLACES[name]
                report[name] = {"name": name, "route": "cuda",
                                "source": f"automerge_tpu_torch/csrc/{source}",
                                "replaces": replaces, **m, "by_path": {}}
            entry = report[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
            entry["by_path"][where] = m
    for name, entry in report.items():
        launches = {path: counts[name] for path, counts in by_path.items()}
        entry["launches"] = sum(launches.values())
        entry["launches_by_path"] = launches

    # sort_winners past 2^20 rows, where a key packing the row would overflow
    wide = winner_columns(WIDE_P, 11, device)
    SO.sort_winners.launches = 0
    got = SO.sort_winners(*wide)
    wide_launches = SO.sort_winners.launches
    wide_keys = group_keys(*wide[:5])
    m = {"P": WIDE_P, **measure("sort_winners", SO.sort_winners,
                                SO.sort_winners_plain, wide, got,
                                lambda: torch.sort(wide_keys), reps)}
    m["launches"] = wide_launches
    report["sort_winners"]["wide"] = m
    report["sort_winners"]["max_abs_err"] = max(
        report["sort_winners"]["max_abs_err"], m["max_abs_err"])
    print(f"sort_winners at P = {WIDE_P}: equal to its plain version in "
          f"{wide_launches} launches", flush=True)
    return [report[name] for name in REPLACES]


def main() -> int:
    if sys.argv[1:2] == ["--obs-cost"]:  # one process of phase (q)
        return obs_cost_child(*sys.argv[2:4])
    # 1. the card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)

    from automerge_tpu_torch.kernels import _build

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {built:.2f} s compiling ({time.perf_counter() - t0:.2f} s "
          f"with cache check), {_build.library_path().name}", flush=True)
    from automerge_tpu_torch import native

    t0 = time.perf_counter()
    built = native.build()
    native.load()
    print(f"native build: {built:.2f} s compiling with g++ "
          f"({' '.join(native.GXX_FLAGS)}; {time.perf_counter() - t0:.2f} s with "
          f"cache check and load), {native.library_path().name}", flush=True)

    if sys.argv[1:] == ["--cards"]:
        cards_paths(card, device)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
            flush=True)
        return 0

    # 3. the main paths
    text_log, text_counts, text_out, text, text_obj, h1_covered = text_path(
        card, device)
    record_log, last, record_counts, record_out, expect = record_paths(card, device)
    check_reference_fault(device)
    cross_counts, cross_spec = cross_doc_paths(card, device)
    obs_paths(card, device)
    obs_cost(card)
    typing_log, condensed_counts = condensed_paths(
        card, device, (text_log, text_out, text, text_obj),
        (record_log, record_out, expect))
    del text_out, record_out
    document_counts = document_paths(card, device)
    sync_counts = sync_paths(card, device)
    durable_counts = durable_paths(card, device)
    serve_counts, serve_spec = serve_paths(card, device)
    cluster_counts = cluster_paths(card, device)
    sessions_counts = cli_sessions_paths(card, device)
    capi_counts = capi_paths(card, device)
    cold_counts = cold_open_paths(card, device)
    sharded_counts = sharded_paths(card, device, (text_log, text_obj), typing_log,
                                   record_log)

    # 4./5. every kernel against its plain version at each path's shapes;
    # the whole merge against the CPU on a small fan-in and a served subset
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import condensed_caps

    by_path = {**text_counts, **record_counts, **cross_counts, **condensed_counts,
               **document_counts, **sync_counts, **durable_counts, **serve_counts,
               **cluster_counts, **sessions_counts, **capi_counts, **cold_counts,
               **sharded_counts}

    def spec(log, condensed=False):
        return (log.padded_columns(include_aorder=condensed), log.n_objs,
                len(log.props), *((condensed_caps(log),) if condensed else ()))

    text_cols, record_cols = spec(text_log), spec(record_log)
    view_cols = (text_log.padded_columns(covered=h1_covered), *text_cols[1:])
    paths = {"text": text_cols, "text expand": text_cols,
             "text packed": text_cols, "text view": view_cols,
             "text view packed": (*view_cols, DeviceDoc.VIEW_FETCH),
             "records": record_cols,
             "records expand": record_cols, "records packed": record_cols,
             "served": last, "cross-doc": cross_spec, "served rpc": serve_spec,
             "text condensed": spec(text_log, True),
             "typing": spec(typing_log),
             "typing condensed": spec(typing_log, True),
             "records condensed": spec(record_log, True),
             "text sharded": (*text_cols, "condensed"),
             "text sharded rows": (*text_cols, "rows"),
             "text sharded 16": (*text_cols, "condensed", SIXTEEN),
             "typing sharded rows": (*spec(typing_log), "rows"),
             "records sharded": (*record_cols, "condensed")}
    report = kernel_report(paths, by_path, device, REPS)
    check_served_subset(last, device)
    check_small_against_cpu(device)
    print("small fan-in: cuda == cpu on all outputs", flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)

    # 6. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
