"""LZFSE container decode — block-type dispatch loop (exact scalar spec).

A container is a concatenation of self-describing blocks terminated by the EOS
magic "bvx$". Reference: src/decode/decoder.rs:72-99.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .errors import (BadBlock, DecodeError, PayloadOverflow,
                           PayloadUnderflow)
from . import fse as F
from . import vn as V
from . import weights as W
from .lz import LzSink
from .tables import DecoderTables


def decode_bytes(src: bytes) -> bytes:
    """Decode a complete LZFSE container. Totally-defined: raises DecodeError
    subclasses on any malformed input."""
    sink = LzSink()
    pos = 0
    n = len(src)
    while True:
        if n - pos < 4:
            raise PayloadUnderflow("container truncated")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic == C.MAGIC_EOS:
            break
        if magic == C.MAGIC_VX2:
            pos = _decode_vx2(src, pos, sink)
        elif magic == C.MAGIC_VX1:
            pos = _decode_vx1(src, pos, sink)
        elif magic == C.MAGIC_VXN:
            pos = _decode_vxn(src, pos, sink)
        elif magic == C.MAGIC_RAW:
            pos = _decode_raw(src, pos, sink)
        else:
            raise BadBlock(magic)
    if n - pos != 4:
        raise PayloadOverflow("trailing bytes after EOS")
    return bytes(sink.buf)


def probe(src: bytes) -> tuple[int, int]:
    """Walk blocks summing (n_payload_bytes, n_raw_bytes) without decoding.

    Reference: src/decode/probe.rs:11-35 plus the per-type probes.
    """
    pos = 0
    n_raw = 0
    n = len(src)
    while True:
        if n - pos < 4:
            raise PayloadUnderflow("container truncated")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic == C.MAGIC_EOS:
            pos += 4
            return pos, n_raw
        if magic == C.MAGIC_VX2:
            block, n_weights = F.load_v2_header(src[pos:pos + C.V2_HEADER_SIZE])
            n_raw += block.n_raw_bytes
            pos += (C.V2_HEADER_SIZE + n_weights + block.literal.n_payload_bytes
                    + block.lmd.n_payload_bytes)
        elif magic == C.MAGIC_VX1:
            block = F.load_v1_header(src[pos:pos + C.V1_HEADER_SIZE])
            n_raw += block.n_raw_bytes
            pos += (C.V1_HEADER_SIZE + C.V1_WEIGHT_PAYLOAD_BYTES
                    + block.literal.n_payload_bytes + block.lmd.n_payload_bytes)
        elif magic == C.MAGIC_VXN:
            if n - pos < C.VN_HEADER_SIZE:
                raise PayloadUnderflow("vn header truncated")
            n_raw += int.from_bytes(src[pos + 4:pos + 8], "little")
            pos += C.VN_HEADER_SIZE + int.from_bytes(src[pos + 8:pos + 12], "little")
        elif magic == C.MAGIC_RAW:
            if n - pos < C.RAW_HEADER_SIZE:
                raise PayloadUnderflow("raw header truncated")
            n_raw_blk = int.from_bytes(src[pos + 4:pos + 8], "little")
            n_raw += n_raw_blk
            pos += C.RAW_HEADER_SIZE + n_raw_blk
        else:
            raise BadBlock(magic)


def _take(src: bytes, pos: int, n: int) -> bytes:
    if pos + n > len(src):
        raise PayloadUnderflow("block truncated")
    return src[pos:pos + n]


def _decode_fse_payloads(src: bytes, pos: int, block: F.FseBlock,
                         weights: np.ndarray, payload_start: int,
                         sink: LzSink) -> int:
    """Shared Vx1/Vx2 literal + LMD payload decode.

    `payload_start` points at the literal payload; the 8 bytes preceding it are
    borrowed as the reader pad (fse_core.rs:30-33, load_v1/v2 return value -8).
    """
    tables = DecoderTables(weights)
    lit_payload = _take(src, payload_start - 8,
                        block.literal.n_payload_bytes + 8)
    literals = F.decode_literals(lit_payload, tables, block.literal)
    lmd_start = payload_start + block.literal.n_payload_bytes
    lmd_payload = _take(src, lmd_start, block.lmd.n_payload_bytes)
    lmds = F.decode_lmds(lmd_payload, tables, block.lmd)

    # Fused LMD walk + LZ reconstruction with the validation set of
    # FseCore::decode_internal (fse_core.rs:91-141).
    literal_index = 0
    n_match_bytes = 0
    match_distance = 0
    raw_mark = len(sink)
    for l, m, d in lmds.tolist():
        if d != 0:
            match_distance = d
        end = literal_index + l
        if end > C.LITERALS_PER_BLOCK or end > len(literals):
            raise F.FseError("BadLmdPayload", "literal overrun")
        sink.write_bytes(literals[literal_index:end])
        literal_index = end
        if m != 0:
            n_match_bytes += m
            sink.write_match(m, match_distance)
    if (literal_index > block.literal.num
            or n_match_bytes + literal_index != block.n_raw_bytes):
        raise F.FseError("BadLmdPayload", "raw byte count mismatch")
    assert len(sink) - raw_mark == block.n_raw_bytes
    return lmd_start + block.lmd.n_payload_bytes


def _decode_vx2(src: bytes, pos: int, sink: LzSink) -> int:
    block, n_weights = F.load_v2_header(_take(src, pos, C.V2_HEADER_SIZE))
    weight_payload = _take(src, pos + C.V2_HEADER_SIZE, n_weights)
    weights = W.load_v2(weight_payload)
    payload_start = pos + C.V2_HEADER_SIZE + n_weights
    return _decode_fse_payloads(src, pos, block, weights, payload_start, sink)


def _decode_vx1(src: bytes, pos: int, sink: LzSink) -> int:
    block = F.load_v1_header(_take(src, pos, C.V1_HEADER_SIZE))
    weight_payload = _take(src, pos + C.V1_HEADER_SIZE, C.V1_WEIGHT_PAYLOAD_BYTES)
    weights = W.load_v1(weight_payload)
    payload_start = pos + C.V1_HEADER_SIZE + C.V1_WEIGHT_PAYLOAD_BYTES
    return _decode_fse_payloads(src, pos, block, weights, payload_start, sink)


def _decode_vxn(src: bytes, pos: int, sink: LzSink) -> int:
    header = _take(src, pos, C.VN_HEADER_SIZE)
    n_raw_bytes = int.from_bytes(header[4:8], "little")
    n_payload_bytes = int.from_bytes(header[8:12], "little")
    payload = _take(src, pos + C.VN_HEADER_SIZE, n_payload_bytes)
    V.decode_vn(payload, n_raw_bytes, n_payload_bytes, sink)
    return pos + C.VN_HEADER_SIZE + n_payload_bytes


def _decode_raw(src: bytes, pos: int, sink: LzSink) -> int:
    header = _take(src, pos, C.RAW_HEADER_SIZE)
    n_raw_bytes = int.from_bytes(header[4:8], "little")
    data = _take(src, pos + C.RAW_HEADER_SIZE, n_raw_bytes)
    sink.write_bytes(data)
    return pos + C.RAW_HEADER_SIZE + n_raw_bytes
