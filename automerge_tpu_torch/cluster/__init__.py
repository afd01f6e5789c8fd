"""Cluster tier: multi-node sharded serving with journal-shipping
replication and leader failover.

* hashring.py     — consistent-hash placement of documents onto groups
* replication.py  — leader-side hub shipping acked journal records,
                    follower catch-up (snapshot + journal tail), the
                    quorum ack gate
* node.py         — a backend node: socket server + leader/follower
                    role + the cluster RPC surface
* router.py       — the client-facing proxy: placement, handle
                    virtualization, heartbeat failover, live migration
* chaos.py        — the chaos fabric: a seeded TCP fault interposer
                    (drop/delay/throttle/partition/sever) + scripted
                    fault schedules for the soak
"""

from .chaos import ChaosProxy, ChaosSchedule, LinkPolicy
from .hashring import HashRing
from .node import ClusterNode, ClusterRpcServer, REPL_SHARD_KEY
from .replication import (
    ReplicationError,
    ReplicationHub,
    ReplicationTimeout,
    decode_batch,
    decode_cursor,
    encode_batch,
    encode_cursor,
)
from .router import ClusterRouter

__all__ = [
    "ChaosProxy",
    "ChaosSchedule",
    "ClusterNode",
    "ClusterRouter",
    "ClusterRpcServer",
    "HashRing",
    "LinkPolicy",
    "REPL_SHARD_KEY",
    "ReplicationError",
    "ReplicationHub",
    "ReplicationTimeout",
    "decode_batch",
    "decode_cursor",
    "encode_batch",
    "encode_cursor",
]
