"""Concurrent serving layer: socket transport + per-document shards.

``SocketRpcServer`` (serve/server.py) serves the stdio JSON-RPC protocol
over TCP or unix-domain sockets through a per-document single-writer
shard pool (serve/shards.py), with group-commit durability and
sync-receive coalescing, every document on the server's ``device``
(None: the card). ``python -m automerge_tpu_torch.rpc --socket`` /
``--unix`` is the command-line entry.
"""

from .server import SocketRpcServer  # noqa: F401
from .shards import QueueFull, ShardPool  # noqa: F401
