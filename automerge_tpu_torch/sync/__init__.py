from .bloom import BloomFilter
from .faults import Channel, FaultyChannel, SyncDriver
from .protocol import (
    Have,
    Message,
    SyncError,
    SyncState,
    generate_sync_message,
    receive_sync_message,
    sync,
)
from .session import SessionConfig, SyncSession

__all__ = [
    "BloomFilter",
    "Channel",
    "FaultyChannel",
    "Have",
    "Message",
    "SessionConfig",
    "SyncDriver",
    "SyncError",
    "SyncState",
    "SyncSession",
    "generate_sync_message",
    "receive_sync_message",
    "sync",
]
