"""Chunk framing: magic bytes, checksum, type byte, length prefix.

Byte-compatible with the reference (reference:
rust/automerge/src/storage/chunk.rs, storage.rs MAGIC_BYTES). A chunk is:

    magic (4 bytes: 85 6f 4a 83)
    checksum (4 bytes: first 4 bytes of the chunk hash)
    chunk type (1 byte: 0=document, 1=change, 2=compressed change)
    data length (ULEB128)
    data

The chunk hash — which doubles as the change hash for change chunks — is
SHA-256 over (type byte || ULEB(len) || data).
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Iterator, NamedTuple

from ..utils.leb128 import LEBDecodeError, decode_uleb, encode_uleb

MAGIC_BYTES = bytes([0x85, 0x6F, 0x4A, 0x83])

CHUNK_DOCUMENT = 0
CHUNK_CHANGE = 1
CHUNK_COMPRESSED = 2

DEFLATE_MIN_SIZE = 256  # reference: storage/change.rs DEFLATE_MIN_SIZE


from ..errors import AutomergeError


class ChunkParseError(AutomergeError):
    pass


def chunk_hash(chunk_type: int, data: bytes) -> bytes:
    body = bytearray([chunk_type])
    encode_uleb(len(data), body)
    body += data
    return hashlib.sha256(bytes(body)).digest()


class RawChunk(NamedTuple):
    chunk_type: int
    checksum: bytes  # 4 bytes as stored
    hash: bytes  # 32-byte SHA-256 of (type || len || data)
    data: bytes
    offset: int = -1  # position in the scanned buffer (scan_chunks sets it)

    @property
    def checksum_valid(self) -> bool:
        return self.hash[:4] == self.checksum


def write_chunk(chunk_type: int, data: bytes) -> bytes:
    h = chunk_hash(chunk_type, data)
    out = bytearray(MAGIC_BYTES)
    out += h[:4]
    out.append(chunk_type)
    encode_uleb(len(data), out)
    out += data
    return bytes(out)


def parse_chunk(buf: bytes, pos: int = 0) -> tuple[RawChunk, int]:
    """Parse one chunk starting at ``pos``; returns (chunk, new_pos).

    Compressed change chunks are inflated transparently: the returned chunk is
    the equivalent uncompressed change chunk (its stored checksum is the
    original's, which the reference derives from the *uncompressed* data).
    """
    # header = magic(4) + checksum(4) + type(1): 9 bytes before the length
    # field, so an 8-byte-exact input is still truncated
    if pos + 9 > len(buf):
        raise ChunkParseError("truncated chunk header")
    if buf[pos : pos + 4] != MAGIC_BYTES:
        raise ChunkParseError("invalid magic bytes")
    checksum = bytes(buf[pos + 4 : pos + 8])
    chunk_type = buf[pos + 8]
    if chunk_type > CHUNK_COMPRESSED:
        raise ChunkParseError(f"unknown chunk type {chunk_type}")
    try:
        length, data_start = decode_uleb(buf, pos + 9)
    except LEBDecodeError as e:
        raise ChunkParseError(
            f"chunk length field at byte {pos + 9} runs past end of input: {e}"
        ) from e
    data_end = data_start + length
    if data_end > len(buf):
        raise ChunkParseError("chunk data extends past end of input")
    data = bytes(buf[data_start:data_end])
    if chunk_type == CHUNK_COMPRESSED:
        try:
            data = zlib.decompress(data, wbits=-15)  # raw DEFLATE stream
        except zlib.error as e:
            raise ChunkParseError(f"invalid deflate stream: {e}") from e
        chunk_type = CHUNK_CHANGE
    h = chunk_hash(chunk_type, data)
    return RawChunk(chunk_type, checksum, h, data), data_end


class DroppedRegion(NamedTuple):
    """A byte range skipped by ``scan_chunks``: [offset, end) plus why."""

    offset: int
    end: int
    reason: str
    checksum: bytes  # stored checksum when the header was readable, else b""
    hash: bytes  # computed hash when the chunk parsed at all, else b""


def scan_chunks(buf: bytes) -> Iterator["RawChunk | DroppedRegion"]:
    """Fault-tolerant chunk walk: yield every verifiable chunk and a
    ``DroppedRegion`` for every corrupt span.

    It never raises on malformed input: a chunk
    that fails to parse or whose checksum does not match is reported as
    dropped, and the scan resynchronises at the next ``MAGIC_BYTES``
    occurrence (trusting the corrupt chunk's own length field only when
    it lands exactly on another magic marker or end-of-input).

    Carving caveat: resynchronisation cannot tell a real chunk boundary
    from chunk-shaped bytes *inside* a corrupt span — e.g. a save stored
    as a bytes scalar within the damaged chunk. Chunks recovered after a
    ``DroppedRegion`` may therefore originate from embedded data; every
    resync point is visible as that region's ``end``, so callers needing
    certainty can treat post-resync chunks as suspect.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        chunk = None
        end = None
        reason = ""
        try:
            chunk, end = parse_chunk(buf, pos)
        except Exception as e:  # any decode error, incl. nested LEB/zlib
            reason = str(e) or type(e).__name__
        if chunk is not None and chunk.checksum_valid:
            yield chunk._replace(offset=pos)
            pos = end
            continue
        # corrupt span: decide where to resume. Only a span that actually
        # starts with magic bytes has a readable checksum field — anything
        # else would present arbitrary garbage as a chunk identity.
        header_readable = (
            pos + 8 <= n and bytes(buf[pos : pos + 4]) == MAGIC_BYTES
        )
        checksum = bytes(buf[pos + 4 : pos + 8]) if header_readable else b""
        if chunk is not None:
            reason = "checksum mismatch"
            if end == n or buf[end : end + 4] == MAGIC_BYTES:
                resume = end  # length field still framed the chunk correctly
            else:
                resume = _next_magic(buf, pos + 1)
        else:
            resume = _next_magic(buf, pos + 1)
        yield DroppedRegion(
            offset=pos,
            end=resume,
            reason=reason,
            checksum=checksum,
            hash=chunk.hash if chunk is not None else b"",
        )
        pos = resume


def _next_magic(buf: bytes, start: int) -> int:
    nxt = buf.find(MAGIC_BYTES, start)
    return nxt if nxt != -1 else len(buf)

