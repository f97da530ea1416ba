"""Scalar bitstream model for LZFSE FSE payloads.

The LZFSE FSE bitstream is written forward (values pushed LSB-first into a
little-endian byte stream) and read *backwards*: the decoder starts at the end
of the payload and pulls values in reverse push order. See the reference
semantics in src/bits/bit_writer.rs (push/finalize) and src/bits/bit_reader.rs
(pull/flush/finalize).

We model this directly with an absolute bit position over the payload's
little-endian bit string:

  writer: value v pushed with n bits occupies bit positions [pos, pos+n), pos += n
  reader: pos starts at 8*len - off; pull(n): pos -= n, return bits [pos, pos+n)

`off` is the 0..=7 bit padding recorded in the block header; the top `off` bits
of the final byte group must be zero or the stream is rejected (BadBitStream,
bit_reader.rs:25-27). The reader may legally drift below its logical start into
an 8-byte pad region (zero bits); consuming below bit 64 overall is a
PayloadUnderflow (bit_reader.rs:65-71).
"""

from __future__ import annotations

from .errors import BadBitStream, PayloadUnderflow


class BitReader:
    """Backwards reader over an FSE payload (includes its 8-byte leading pad)."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, payload: bytes, off: int):
        if off > 7:
            raise BadBitStream("bit offset > 7")
        if len(payload) < 8:
            raise PayloadUnderflow("payload shorter than 8 bytes")
        # Reject non-zero bits above the logical stream end, mirroring
        # BitReader::new (bit_reader.rs:25-27): the check covers the top `off`
        # bits of the final 8-byte accumulator load.
        if off != 0:
            tail = int.from_bytes(payload[-8:], "little")
            if tail >> (64 - off) != 0:
                raise BadBitStream("non-zero padding bits")
        # Pad by 8 bytes at the front (reads below 0 yield zero bits) and 4 at
        # the back so 4-byte windows never index out of range.
        self._buf = b"\x00" * 8 + bytes(payload) + b"\x00" * 4
        self._pos = 64 + len(payload) * 8 - off  # absolute bit position

    def pull(self, n_bits: int) -> int:
        """Pull `n_bits` (<= 25) in reverse stream order."""
        pos = self._pos - n_bits
        self._pos = pos
        if pos < 0:
            # Deep underflow: the reference reads zeros below the buffer.
            return 0
        window = int.from_bytes(self._buf[pos >> 3: (pos >> 3) + 4], "little")
        return (window >> (pos & 7)) & ((1 << n_bits) - 1)

    def finalize(self) -> None:
        """Validate that the reader never consumed into the 8-byte pad.

        Mirrors BitReader::finalize (bit_reader.rs:65-71): >= 64 bits must
        remain above the source base. The payload handed to this reader
        always carries its 8-byte pad/borrow prefix (LMD payloads are padded
        by format; literal payloads borrow the preceding container bytes —
        fse_core.rs:32), so in our coordinates (64 scratch bits + payload)
        the reader must stop at or above bit 128."""
        if self._pos < 128:
            raise PayloadUnderflow("bitstream underflow")


class BitWriter:
    """Forward writer producing an FSE payload byte string."""

    __slots__ = ("_accum", "_accum_bits", "_out")

    def __init__(self):
        self._accum = 0
        self._accum_bits = 0
        self._out = bytearray()

    def push(self, bits: int, n_bits: int) -> None:
        assert bits >> n_bits == 0, "pushed value wider than n_bits"
        self._accum |= bits << self._accum_bits
        self._accum_bits += n_bits
        # Flush whole bytes out of the accumulator (bit_writer.rs:22-32).
        n_bytes = self._accum_bits >> 3
        if n_bytes:
            self._out += (self._accum & ((1 << (n_bytes * 8)) - 1)).to_bytes(
                n_bytes, "little")
            self._accum >>= n_bytes * 8
            self._accum_bits -= n_bytes * 8

    def finalize(self) -> tuple[bytes, int]:
        """Flush the tail. Returns (payload_bytes, off) with off in 0..=7."""
        off = 0
        if self._accum_bits:
            n_bytes = (self._accum_bits + 7) // 8
            self._out += self._accum.to_bytes(n_bytes, "little")
            off = n_bytes * 8 - self._accum_bits
            self._accum = 0
            self._accum_bits = 0
        return bytes(self._out), off
