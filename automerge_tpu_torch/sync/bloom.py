"""Bloom filter for sync-protocol change-set summaries.

Wire- and probe-compatible with the reference (reference:
rust/automerge/src/sync/bloom.rs): 10 bits/entry, 7 probes (~1% false
positives), probes derived by triple hashing from the change hash itself —
the hash is already a SHA-256 digest, so its first twelve bytes serve as
three independent 32-bit hash values. Parameters are carried in the wire
format, so they can change without breaking the protocol.
"""

from __future__ import annotations

import math
from typing import Iterable, List

from ..utils.leb128 import decode_uleb, encode_uleb

BITS_PER_ENTRY = 10
NUM_PROBES = 7


class BloomFilter:
    __slots__ = ("num_entries", "num_bits_per_entry", "num_probes", "bits")

    def __init__(
        self,
        num_entries: int = 0,
        num_bits_per_entry: int = BITS_PER_ENTRY,
        num_probes: int = NUM_PROBES,
        bits: bytes = b"",
    ):
        self.num_entries = num_entries
        self.num_bits_per_entry = num_bits_per_entry
        self.num_probes = num_probes
        self.bits = bytearray(bits)

    @classmethod
    def from_hashes(cls, hashes: Iterable[bytes]) -> "BloomFilter":
        hashes = list(hashes)
        f = cls(num_entries=len(hashes))
        f.bits = bytearray(_bits_capacity(len(hashes), f.num_bits_per_entry))
        for h in hashes:
            f._add_hash(h)
        return f

    # -- probes ------------------------------------------------------------

    def _probes(self, h: bytes) -> List[int]:
        modulo = 8 * len(self.bits)
        x = int.from_bytes(h[0:4], "little") % modulo
        y = int.from_bytes(h[4:8], "little") % modulo
        z = int.from_bytes(h[8:12], "little") % modulo
        probes = [x]
        for _ in range(1, self.num_probes):
            x = (x + y) % modulo
            y = (y + z) % modulo
            probes.append(x)
        return probes

    def _add_hash(self, h: bytes) -> None:
        for p in self._probes(h):
            self.bits[p >> 3] |= 1 << (p & 7)

    def contains(self, h: bytes) -> bool:
        if self.num_entries == 0 or not self.bits:
            return False
        return all(self.bits[p >> 3] & (1 << (p & 7)) for p in self._probes(h))

    # -- wire format -------------------------------------------------------

    def to_bytes(self) -> bytes:
        if self.num_entries == 0:
            return b""
        out = bytearray()
        encode_uleb(self.num_entries, out)
        encode_uleb(self.num_bits_per_entry, out)
        encode_uleb(self.num_probes, out)
        out += self.bits
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BloomFilter":
        if not data:
            return cls()
        pos = 0
        num_entries, pos = decode_uleb(data, pos)
        bpe, pos = decode_uleb(data, pos)
        probes, pos = decode_uleb(data, pos)
        # untrusted input: reject parameters outside u32 (reference parses
        # with leb128_u32) and cap probes/bits-per-entry so a malicious
        # filter cannot make contains() loop unboundedly
        if num_entries >= 1 << 32 or bpe >= 1 << 32 or probes >= 1 << 32:
            raise ValueError("bloom filter parameter exceeds u32")
        if probes > 1024 or bpe > 1024:
            raise ValueError("unreasonable bloom filter parameters")
        cap = _bits_capacity(num_entries, bpe)
        if len(data) - pos < cap:
            raise ValueError("bloom filter bits truncated")
        return cls(num_entries, bpe, probes, data[pos : pos + cap])

    def __eq__(self, other):
        return (
            isinstance(other, BloomFilter)
            and self.num_entries == other.num_entries
            and self.num_bits_per_entry == other.num_bits_per_entry
            and self.num_probes == other.num_probes
            and self.bits == other.bits
        )


def _bits_capacity(num_entries: int, bits_per_entry: int) -> int:
    return math.ceil(num_entries * bits_per_entry / 8)
