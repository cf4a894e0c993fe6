"""Snappy framing-format decoding for `.skf` loads (the port's copy of
the reading half of ska_tpu/io/snappy.py).

The reference persists `.skf` with snap's FrameEncoder
(merge_ska_array.rs:191-204). The whole frame is decoded, and every
chunk's masked CRC-32C checked, by the host library
(csrc/host/skanative.cpp); the writing half lives in csrc/host/save.cpp.
"""

from . import native

_MAGIC = b"\xff\x06\x00\x00sNaPpY"


def frame_decompress(buf):
    """Decode a framed stream (framing_format.txt); raises ValueError on
    a malformed frame or a checksum mismatch."""
    buf = bytes(buf)
    if buf[:10] != _MAGIC:
        raise ValueError("not a snappy framed stream")
    return native.snappy_frame_decompress(buf)
