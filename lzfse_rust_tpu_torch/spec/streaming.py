"""Pure-Python incremental container decoder (spec-layer fallback).

Provides the same push/pull/finish protocol as the native
runtime.native.StreamDecoder so the streaming API objects work without the
compiled runtime. Granularity is one block: a block's raw bytes materialize
together, and memory is bounded by one block's carry plus the retained match
history — O(block), not the native engine's O(1). The native stream is the
performance/parity path; this layer documents the semantics in executable
form (reference: ReaderCore::fill, src/decode/reader_core.rs:56-99).
"""

from __future__ import annotations

from ..base import constants as C
from ..base.errors import BadBlock, DecodeError, PayloadOverflow, PayloadUnderflow
from . import container as _container
from . import fse as F
from .lz import LzSink

# retain at least the maximum representable match distance (262139)
_HISTORY = 1 << 18


class _WindowedLzSink(LzSink):
    """LzSink whose buffer may be trimmed from the front once bytes are both
    drained by the consumer and older than the match-history window."""

    __slots__ = ("buf", "base")

    def __init__(self):
        super().__init__()
        self.base = 0  # bytes trimmed from the front

    def write_match(self, match_len: int, match_distance: int) -> None:
        # distances are validated against total produced output; any valid
        # distance (<= 262139) is always within the retained window
        if match_distance > len(self.buf) and \
                match_distance <= self.base + len(self.buf):
            raise DecodeError("match history trimmed (internal)")
        super().write_match(match_len, match_distance)

    def produced(self) -> int:
        return self.base + len(self.buf)

    def trim(self, drained_total: int) -> None:
        keep_from = min(drained_total, self.produced() - _HISTORY)
        cut = keep_from - self.base
        if cut > _HISTORY:  # amortize: only trim in big steps
            del self.buf[:cut]
            self.base += cut


class SpecStreamDecoder:
    """Incremental block-at-a-time decoder with bounded carry + history."""

    def __init__(self):
        self._carry = bytearray()
        self._sink = _WindowedLzSink()
        self._drained = 0
        self._raw_left = 0  # RAW body bytes still streaming through
        self._done = False
        self._err: Exception | None = None

    # -- protocol -----------------------------------------------------------

    def push(self, data: bytes) -> int:
        if self._err is not None:
            raise self._err
        used = 0
        try:
            used = self._advance(data)
        except Exception as e:  # latch: every later call re-raises
            self._err = e
            raise
        return used

    def pull(self, cap: int | None = None) -> bytes:
        if self._err is not None:
            raise self._err
        avail = self._sink.produced() - self._drained
        n = avail if cap is None else min(cap, avail)
        start = self._drained - self._sink.base
        out = bytes(self._sink.buf[start:start + n])
        self._drained += n
        self._sink.trim(self._drained)
        return out

    def finish(self) -> None:
        if self._err is not None:
            raise self._err
        if not self._done or self._carry:
            self._err = PayloadUnderflow("container truncated")
            raise self._err

    def close(self) -> None:
        pass

    # -- internals ----------------------------------------------------------

    def _advance(self, data: bytes) -> int:
        used = 0
        n = len(data)
        while True:
            if self._raw_left:
                take = min(self._raw_left, n - used)
                self._sink.write_bytes(data[used:used + take])
                used += take
                self._raw_left -= take
                if self._raw_left:
                    return used  # out of input
                continue
            if self._done:
                if used < n or self._carry:
                    raise PayloadOverflow("trailing bytes after EOS")
                return used
            # how much does the pending block need?
            need = self._block_need()
            if need is None or len(self._carry) < need:
                want = need if need is not None else self._header_need()
                take = min(n - used, want - len(self._carry))
                if take == 0:
                    return used
                self._carry += data[used:used + take]
                used += take
                continue
            self._process_block(need)

    def _header_need(self) -> int:
        c = self._carry
        if len(c) < 4:
            return 4
        magic = int.from_bytes(c[:4], "little")
        return {C.MAGIC_RAW: C.RAW_HEADER_SIZE,
                C.MAGIC_VXN: C.VN_HEADER_SIZE,
                C.MAGIC_VX2: C.V2_HEADER_SIZE,
                C.MAGIC_VX1: C.V1_HEADER_SIZE}.get(magic, 4)

    def _block_need(self) -> int | None:
        """Total bytes the block at the carry head requires, or None if the
        header itself is still incomplete."""
        c = self._carry
        if len(c) < 4:
            return None
        magic = int.from_bytes(c[:4], "little")
        if magic == C.MAGIC_EOS:
            return 4
        if magic == C.MAGIC_RAW:
            return C.RAW_HEADER_SIZE if len(c) >= C.RAW_HEADER_SIZE else None
        if magic == C.MAGIC_VXN:
            if len(c) < C.VN_HEADER_SIZE:
                return None
            n_pay = int.from_bytes(c[8:12], "little")
            return C.VN_HEADER_SIZE + n_pay
        if magic == C.MAGIC_VX2:
            if len(c) < C.V2_HEADER_SIZE:
                return None
            block, n_weights = F.load_v2_header(bytes(c[:C.V2_HEADER_SIZE]))
            return (C.V2_HEADER_SIZE + n_weights
                    + block.literal.n_payload_bytes + block.lmd.n_payload_bytes)
        if magic == C.MAGIC_VX1:
            if len(c) < C.V1_HEADER_SIZE:
                return None
            block = F.load_v1_header(bytes(c[:C.V1_HEADER_SIZE]))
            return (C.V1_HEADER_SIZE + C.V1_WEIGHT_PAYLOAD_BYTES
                    + block.literal.n_payload_bytes + block.lmd.n_payload_bytes)
        raise BadBlock(magic)

    def _process_block(self, need: int) -> None:
        src = bytes(self._carry[:need])
        magic = int.from_bytes(src[:4], "little")
        if magic == C.MAGIC_EOS:
            self._done = True
        elif magic == C.MAGIC_RAW:
            self._raw_left = int.from_bytes(src[4:8], "little")
        elif magic == C.MAGIC_VX2:
            _container._decode_vx2(src, 0, self._sink)
        elif magic == C.MAGIC_VX1:
            _container._decode_vx1(src, 0, self._sink)
        else:  # MAGIC_VXN (validated in _block_need)
            _container._decode_vxn(src, 0, self._sink)
        del self._carry[:need]
