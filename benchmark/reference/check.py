"""Walks, counts and comparisons of LZFSE containers, by the format alone.

``walk`` lists a container's blocks from their headers; ``fse_work`` counts
what the FSE blocks of a batch hold (the roofline's work); the
``check_*`` functions compare a run's outputs with what the plain
reference gives for the same raw inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from . import container as SC
from . import fse as F
from . import frontend as SF
from .errors import DecodeError
from .lz import LzSink

# Bytes a decoded L, M or D value takes: the format's decoded values are
# 32-bit integers (the spec decoder's int32 rows).
LMD_VALUE_BYTES = 4
# Operations a coded symbol costs at least: a table lookup, a shift, a
# mask, an add and a position update (the port's chip_smoke.py figure).
OPS_PER_SYMBOL = 5
# History the format lets a match reach back: MAX_D_VALUE bytes.
_HISTORY = C.MAX_D_VALUE


@dataclass(frozen=True)
class Block:
    kind: str          # "fse" (Vx1 or Vx2), "vn", "raw"
    pos: int           # first byte of the block in the container
    end: int           # one past its last byte
    raw_start: int     # first raw byte it decodes to
    n_raw: int
    n_literals: int = 0
    n_matches: int = 0
    payload: int = 0   # literal + L/M/D payload bytes (FSE)


def walk(src: bytes) -> list[Block]:
    """The blocks of a container, from their headers. Raises
    ``DecodeError`` on a bad magic, a truncated block or bytes after the
    end-of-stream block."""
    out: list[Block] = []
    pos = raw = 0
    n = len(src)
    while True:
        if n - pos < 4:
            raise DecodeError("container truncated")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic == C.MAGIC_EOS:
            if n - pos != 4:
                raise DecodeError("trailing bytes after EOS")
            return out
        if magic in (C.MAGIC_VX2, C.MAGIC_VX1):
            if magic == C.MAGIC_VX2:
                blk, nw = F.load_v2_header(src[pos:pos + C.V2_HEADER_SIZE])
                head = C.V2_HEADER_SIZE + nw
            else:
                blk = F.load_v1_header(src[pos:pos + C.V1_HEADER_SIZE])
                head = C.V1_HEADER_SIZE + C.V1_WEIGHT_PAYLOAD_BYTES
            pay = blk.literal.n_payload_bytes + blk.lmd.n_payload_bytes
            b = Block("fse", pos, pos + head + pay, raw, blk.n_raw_bytes,
                      blk.literal.num, blk.lmd.num, pay)
        elif magic == C.MAGIC_VXN:
            if n - pos < C.VN_HEADER_SIZE:
                raise DecodeError("vn header truncated")
            b = Block("vn", pos, pos + C.VN_HEADER_SIZE
                      + int.from_bytes(src[pos + 8:pos + 12], "little"), raw,
                      int.from_bytes(src[pos + 4:pos + 8], "little"))
        elif magic == C.MAGIC_RAW:
            if n - pos < C.RAW_HEADER_SIZE:
                raise DecodeError("raw header truncated")
            k = int.from_bytes(src[pos + 4:pos + 8], "little")
            b = Block("raw", pos, pos + C.RAW_HEADER_SIZE + k, raw, k)
        else:
            raise DecodeError(f"bad block magic {magic:#x}")
        if b.end > n:
            raise DecodeError("block truncated")
        out.append(b)
        pos, raw = b.end, raw + b.n_raw


def fse_work(containers) -> dict:
    """What the FSE blocks of a batch of containers hold: blocks, literals,
    matches, coded symbols (each literal, and each match's L, M and D), the
    coded bytes (payloads and block headers with their weights) and the
    decoded bytes (a byte a literal, ``LMD_VALUE_BYTES`` a value), and the
    operations (``OPS_PER_SYMBOL`` a symbol)."""
    w = dict(blocks=0, literals=0, matches=0, coded_bytes=0)
    for src in containers:
        for b in walk(src):
            if b.kind == "fse":
                w["blocks"] += 1
                w["literals"] += b.n_literals
                w["matches"] += b.n_matches
                w["coded_bytes"] += b.end - b.pos
    w["symbols"] = w["literals"] + 3 * w["matches"]
    w["decoded_bytes"] = w["literals"] + 3 * LMD_VALUE_BYTES * w["matches"]
    w["ops"] = OPS_PER_SYMBOL * w["symbols"]
    return w


def decode_block(src: bytes, block: Block, history: bytes) -> bytes:
    """The raw bytes of one block, decoded by the spec layer with
    ``history`` (the raw bytes before it, at least the format's match
    reach) in the sink."""
    sink = LzSink()
    sink.buf = bytearray(history)
    step = {C.MAGIC_VX2: SC._decode_vx2, C.MAGIC_VX1: SC._decode_vx1,
            C.MAGIC_VXN: SC._decode_vxn, C.MAGIC_RAW: SC._decode_raw}
    magic = int.from_bytes(src[block.pos:block.pos + 4], "little")
    end = step[magic](src, block.pos, sink)
    if end != block.end:
        raise DecodeError("block length differs from its header")
    return bytes(sink.buf[len(history):])


def pick(rng: np.random.Generator, n: int, k: int) -> list[int]:
    """``k`` distinct indices of ``range(n)`` (all when ``n <= k``)."""
    if n <= k:
        return list(range(n))
    return sorted(int(i) for i in rng.choice(n, k, replace=False))


def _block_bad(container: bytes, block: Block, raw: bytes) -> int:
    """1 when the spec layer, given the block's raw history, does not
    decode ``block`` of ``container`` to the raw bytes it stands for."""
    hist = raw[max(0, block.raw_start - _HISTORY):block.raw_start]
    try:
        got = decode_block(container, block, hist)
    except DecodeError:
        return 1
    return int(got != raw[block.raw_start:block.raw_start + block.n_raw])


def check_blocks(containers, raws, rng: np.random.Generator, k: int) -> dict:
    """Decode ``k`` blocks, drawn by ``rng`` from all blocks of the batch
    (weighted by raw bytes, so large containers are not under-sampled),
    with the spec layer and each block's raw history, and compare with the
    raw bytes they stand for. Returns ``{"blocks": k, "bad": n}``; a
    container that does not walk counts once as bad."""
    bad = 0
    cands = []
    for ci, (src, raw) in enumerate(zip(containers, raws)):
        try:
            blocks = walk(src)
        except DecodeError:
            bad += 1
            continue
        if sum(b.n_raw for b in blocks) != len(raw):
            bad += 1
            continue
        cands += [(ci, b) for b in blocks if b.n_raw]
    if cands:
        weight = np.array([b.n_raw for _, b in cands], float)
        idx = rng.choice(len(cands), min(k, len(cands)), replace=False,
                         p=weight / weight.sum())
        for i in sorted(int(i) for i in idx):
            ci, b = cands[i]
            bad += _block_bad(containers[ci], b, raws[ci])
    return {"blocks": min(k, len(cands)), "bad": int(bad)}


def check_block_each(containers, raws, rng: np.random.Generator,
                     k: int) -> dict:
    """One block, drawn uniformly from its blocks, of each of ``k``
    containers drawn uniformly (so small containers are sampled as often
    as large ones), decoded by the spec layer against its raw bytes.
    Returns ``{"containers": k, "bad": n}``; a container that does not
    walk, or whose blocks do not add up to its raw size, counts as bad."""
    bad = 0
    chosen = pick(rng, len(containers), k)
    for ci in chosen:
        raw = raws[ci] if ci < len(raws) else b""
        try:
            blocks = [b for b in walk(containers[ci]) if b.n_raw]
        except DecodeError:
            bad += 1
            continue
        if sum(b.n_raw for b in blocks) != len(raw):
            bad += 1
        elif blocks:
            b = blocks[int(rng.integers(len(blocks)))]
            bad += _block_bad(containers[ci], b, raw)
    return {"containers": len(chosen), "bad": int(bad)}


def check_prefix(container: bytes, raw: bytes, prefix: int) -> dict:
    """Compare a container with the spec encoder (the reference encoder's
    rules, ``frontend.encode_bytes``) on the first ``prefix`` bytes of its
    raw input. A source no longer than ``prefix`` is compared whole, byte
    for byte; otherwise every block of the reference's encoding of the
    prefix but its last (which the end of the prefix cuts) must equal the
    container's block at the same place. ``prefix`` doubles until at
    least one block is compared. Returns ``{"blocks": compared, "bad":
    differing}``."""
    while len(raw) > prefix:
        ref = SF.encode_bytes(raw[:prefix])
        blocks = walk(ref)[:-1]
        if blocks:
            try:
                mine = walk(container)
            except DecodeError:
                return {"blocks": len(blocks), "bad": len(blocks)}
            bad = sum(k >= len(mine)
                      or container[mine[k].pos:mine[k].end] != ref[b.pos:b.end]
                      for k, b in enumerate(blocks))
            return {"blocks": len(blocks), "bad": int(bad)}
        prefix *= 2
    return {"blocks": 1, "bad": int(SF.encode_bytes(raw) != container)}
