"""LZ77 output reconstruction — the decode sink.

Semantics of LzWriter (reference src/lz/writer.rs): literals append bytes;
a match copies `match_len` bytes from `match_distance` back in the *output*,
byte-serially, so overlapping copies (distance < length) self-extend.
Distance must be in 1..=len(output) (writer.rs:155-177) else BadDValue.
"""

from __future__ import annotations

from .errors import DecodeError


class LzSink:
    """Scalar output accumulator with overlap-safe match copy."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def write_bytes(self, data) -> None:
        self.buf += bytes(data)

    def write_match(self, match_len: int, match_distance: int) -> None:
        buf = self.buf
        n = len(buf)
        if match_distance == 0 or match_distance > n:
            raise DecodeError("BadDValue")
        src = n - match_distance
        if match_distance >= match_len:
            buf += buf[src:src + match_len]
        else:
            # Overlapping self-extending copy: replicate the distance-sized
            # period (equivalent to the reference's byte-serial copy).
            period = buf[src:]
            reps = -(-match_len // match_distance)
            buf += (period * reps)[:match_len]

    def __len__(self) -> int:
        return len(self.buf)

    def n_raw_bytes(self) -> int:
        return len(self.buf)
