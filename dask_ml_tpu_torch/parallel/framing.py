"""Length-prefixed, checksummed frames for snapshot files (the part of
``dask_ml_tpu/parallel/framing.py`` that checkpoints use).

Frame layout, everything big-endian::

    magic (the owner's, with a version byte)
    8-byte unsigned payload length
    sha256(payload), 32 bytes
    payload

The layout and the digest are the JAX package's sha256 tier byte for byte,
so a frame written by either package decodes in the other. A frame that is
missing bytes raises :class:`FrameTruncatedError`; a foreign magic, a
failed digest or trailing bytes raise :class:`FrameCorruptError`.
"""

from __future__ import annotations

import hashlib
import struct

__all__ = [
    "FrameError",
    "FrameTruncatedError",
    "FrameCorruptError",
    "PayloadError",
    "encode_frame",
    "decode_frame",
    "header_length",
]

_LEN_BYTES = 8
_SHA256_BYTES = 32


class FrameError(RuntimeError):
    """Base class for framing failures."""


class FrameTruncatedError(FrameError):
    """The buffer ended before the frame did (a torn write): the header
    promised more bytes than arrived."""


class FrameCorruptError(FrameError):
    """The frame is structurally complete but wrong: foreign magic, or a
    payload whose digest does not match the header's."""


class PayloadError(FrameError):
    """A frame's payload failed decoding although the frame was intact."""


def header_length(magic: bytes) -> int:
    """Total header size for ``magic``: magic + length + digest."""
    return len(magic) + _LEN_BYTES + _SHA256_BYTES


def encode_frame(payload: bytes, *, magic: bytes) -> bytes:
    """``magic + len(payload) (8B BE) + sha256(payload) + payload``."""
    return (magic + struct.pack(">Q", len(payload))
            + hashlib.sha256(payload).digest() + payload)


def decode_frame(data: bytes, *, magic: bytes) -> bytes:
    """Decode one whole-buffer frame into its payload, checking magic,
    length and digest. ``data`` must be exactly one frame: trailing bytes
    are corruption, not a second frame."""
    if data[:len(magic)] != magic:
        raise FrameCorruptError(
            f"bad frame magic {data[:len(magic)]!r} (expected {magic!r})")
    rest = data[len(magic):]
    if len(rest) < _LEN_BYTES + _SHA256_BYTES:
        raise FrameTruncatedError(
            f"truncated frame header ({len(data)} bytes)")
    (length,) = struct.unpack(">Q", rest[:_LEN_BYTES])
    digest = rest[_LEN_BYTES:_LEN_BYTES + _SHA256_BYTES]
    payload = rest[_LEN_BYTES + _SHA256_BYTES:]
    if len(payload) < length:
        raise FrameTruncatedError(
            f"frame payload is {len(payload)} bytes but the header "
            f"recorded {length}")
    if len(payload) > length:
        raise FrameCorruptError(
            f"frame carries {len(payload) - length} trailing bytes past "
            f"the recorded payload length {length}")
    if hashlib.sha256(payload).digest() != digest:
        raise FrameCorruptError("frame payload checksum mismatch")
    return payload
