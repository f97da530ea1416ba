"""FSE (Vx1/Vx2) block codec — exact scalar spec.

Block layout (Vx2, reference src/fse/block.rs:106-196):

    [0:4]   magic "bvx2"
    [4:8]   n_raw_bytes (u32 LE)
    [8:32]  three packed u64 parameter words
    [32:h]  compressed weight payload (h = header_size from word 3)
    [..]    literal tANS payload (literal.n_payload_bytes)
    [..]    LMD tANS payload (lmd.n_payload_bytes, first 8 bytes are zero pad)

The literal payload has no leading pad; the decoder "borrows" the preceding 8
bytes (fse_core.rs:30-33), which our reader model handles by slicing 8 bytes
early. Streams: 4 interleaved literal states (literals.rs:49-133), 3
interleaved L/M/D states (lmds.rs:27-93); encode traverses in reverse.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from .errors import FseError
from .bits import BitReader, BitWriter
from . import weights as W
from .tables import DecoderTables, EncoderTables


def get_bits(p: int, off: int, n: int) -> int:
    return (p >> off) & ((1 << n) - 1)


def set_bits(p: int, off: int, n: int, v: int) -> int:
    assert v >> n == 0
    return p | (v << off)


@dataclass
class LiteralParam:
    num: int = 0
    n_payload_bytes: int = 0
    bits: int = 0
    state: tuple = (0, 0, 0, 0)

    def validate(self) -> None:
        if (self.num % 4 != 0 or self.num > C.LITERALS_PER_BLOCK
                or self.n_payload_bytes > literal_payload_limit(self.num)):
            raise FseError("BadLiteralCount", str(self.num))
        if self.bits > 7 or self.bits < 0:
            raise FseError("BadLiteralBits")
        if any(s >= C.U_STATES or s < 0 for s in self.state):
            raise FseError("BadLmdPayload")


@dataclass
class LmdParam:
    num: int = 0
    n_payload_bytes: int = 0
    bits: int = 0
    state: tuple = (0, 0, 0)

    def validate(self) -> None:
        if (self.num > C.LMDS_PER_BLOCK or self.n_payload_bytes < 8
                or self.n_payload_bytes > lmd_payload_limit(self.num)):
            raise FseError("BadLmdCount", str(self.num))
        if self.bits > 7 or self.bits < 0:
            raise FseError("BadLmdBits")
        s = self.state
        if (s[0] >= C.L_STATES or s[1] >= C.M_STATES or s[2] >= C.D_STATES
                or any(x < 0 for x in s)):
            raise FseError("BadLmdState")


def lmd_payload_limit(num: int) -> int:
    """Naive LMD payload cap with leeway (block.rs:18-20)."""
    return 1024 + 8 + (num * (C.MAX_L_BITS + C.MAX_M_BITS + C.MAX_D_BITS) + 7) // 8


def literal_payload_limit(num: int) -> int:
    """Naive literal payload cap with leeway (block.rs:23-25)."""
    return 1024 + (num * C.MAX_U_BITS + 7) // 8


def n_raw_bytes_limit(n_literals: int, n_lmds: int) -> int:
    return n_literals + n_lmds * C.MAX_M_VALUE


@dataclass
class FseBlock:
    literal: LiteralParam
    lmd: LmdParam
    n_raw_bytes: int

    def validate(self) -> None:
        self.lmd.validate()
        self.literal.validate()
        if self.n_raw_bytes > n_raw_bytes_limit(self.literal.num, self.lmd.num):
            raise FseError("BadRawByteCount")


def load_v2_header(src: bytes) -> tuple[FseBlock, int]:
    """Parse a Vx2 header. Returns (block, n_weight_payload_bytes).

    Exact model of FseBlock::load_v2_internal (block.rs:108-136).
    """
    if len(src) < C.V2_HEADER_SIZE:
        raise FseError("BadLmdPayload", "short header")
    n_raw_bytes = int.from_bytes(src[4:8], "little")
    p0 = int.from_bytes(src[8:16], "little")
    p1 = int.from_bytes(src[16:24], "little")
    p2 = int.from_bytes(src[24:32], "little")
    literal = LiteralParam(
        num=get_bits(p0, 0, 20),
        n_payload_bytes=get_bits(p0, 20, 20),
        bits=7 - get_bits(p0, 60, 3),
        state=(get_bits(p1, 0, 10), get_bits(p1, 10, 10),
               get_bits(p1, 20, 10), get_bits(p1, 30, 10)),
    )
    lmd = LmdParam(
        num=get_bits(p0, 40, 20),
        n_payload_bytes=get_bits(p1, 40, 20),
        bits=7 - get_bits(p1, 60, 3),
        state=(get_bits(p2, 32, 10), get_bits(p2, 42, 10), get_bits(p2, 52, 10)),
    )
    header_size = get_bits(p2, 0, 32)
    n_weight_payload_bytes = (header_size - C.V2_HEADER_SIZE) & 0xFFFFFFFF
    if n_weight_payload_bytes > C.V2_WEIGHT_PAYLOAD_BYTES_MAX:
        raise FseError("BadWeightPayload")
    block = FseBlock(literal, lmd, n_raw_bytes)
    block.validate()
    return block, n_weight_payload_bytes


def store_v2_header(block: FseBlock, n_weight_payload_bytes: int) -> bytes:
    """Pack a Vx2 header (block.rs:168-196)."""
    out = bytearray()
    out += C.MAGIC_VX2.to_bytes(4, "little")
    out += block.n_raw_bytes.to_bytes(4, "little")
    p = 0
    p = set_bits(p, 0, 20, block.literal.num)
    p = set_bits(p, 20, 20, block.literal.n_payload_bytes)
    p = set_bits(p, 40, 20, block.lmd.num)
    p = set_bits(p, 60, 3, 7 - block.literal.bits)
    out += p.to_bytes(8, "little")
    p = 0
    p = set_bits(p, 0, 10, block.literal.state[0])
    p = set_bits(p, 10, 10, block.literal.state[1])
    p = set_bits(p, 20, 10, block.literal.state[2])
    p = set_bits(p, 30, 10, block.literal.state[3])
    p = set_bits(p, 40, 20, block.lmd.n_payload_bytes)
    p = set_bits(p, 60, 3, 7 - block.lmd.bits)
    out += p.to_bytes(8, "little")
    p = 0
    p = set_bits(p, 0, 32, C.V2_HEADER_SIZE + n_weight_payload_bytes)
    p = set_bits(p, 32, 10, block.lmd.state[0])
    p = set_bits(p, 42, 10, block.lmd.state[1])
    p = set_bits(p, 52, 10, block.lmd.state[2])
    out += p.to_bytes(8, "little")
    return bytes(out)


def load_v1_header(src: bytes) -> FseBlock:
    """Parse a Vx1 (uncompressed-weights) header (block.rs:80-104)."""
    if len(src) < C.V1_HEADER_SIZE:
        raise FseError("BadLmdPayload", "short header")
    u32 = lambda off: int.from_bytes(src[off:off + 4], "little")
    u16 = lambda off: int.from_bytes(src[off:off + 2], "little")
    n_raw_bytes = u32(4)
    n_payload_bytes = u32(8)
    literal = LiteralParam(
        num=u32(12), n_payload_bytes=u32(20),
        bits=(-u32(28)) & 0xFFFFFFFF,
        state=(u16(32), u16(34), u16(36), u16(38)))
    lmd = LmdParam(
        num=u32(16), n_payload_bytes=u32(24),
        bits=(-u32(40)) & 0xFFFFFFFF,
        state=(u16(44), u16(46), u16(48)))
    if n_payload_bytes < (literal.n_payload_bytes + lmd.n_payload_bytes) & 0xFFFFFFFF:
        raise FseError("BadPayloadCount")
    block = FseBlock(literal, lmd, n_raw_bytes)
    block.validate()
    return block


# --- Literal stream -----------------------------------------------------------------

def decode_literals(payload: bytes, tables: DecoderTables,
                    param: LiteralParam) -> np.ndarray:
    """Decode the 4-way interleaved literal stream (literals.rs:49-91).

    `payload` must include the 8 borrowed pad bytes at the front.
    """
    reader = BitReader(payload, param.bits)
    u_tab = tables.u
    states = list(param.state)
    out = np.empty(param.num, dtype=np.uint8)
    pull = reader.pull
    for i in range(0, param.num, 4):
        for lane in range(4):
            k, sym, delta = u_tab[states[lane]]
            states[lane] = pull(int(k)) + int(delta)
            out[i + lane] = sym
    reader.finalize()
    if states != [0, 0, 0, 0]:
        raise FseError("BadLmdPayload", "literal final state")
    return out


def encode_literals(literals: np.ndarray, etables: EncoderTables
                    ) -> tuple[bytes, LiteralParam]:
    """Encode literals in reverse with 4 interleaved states (literals.rs:93-133).

    `literals` must already be padded to a multiple of 4.
    """
    n = len(literals)
    assert n % 4 == 0
    writer = BitWriter()
    u_tab = etables.u
    states = [C.U_STATES] * 4
    push = writer.push
    for i in range(n, 0, -4):
        for lane in (3, 2, 1, 0):
            sym = int(literals[i - (4 - lane)])
            t_k, t_w = int(u_tab[sym, 0]), int(u_tab[sym, 1])
            s = states[lane]
            n_bits = (t_k + s) >> 10
            states[lane] = t_w + (s >> n_bits)
            push(s & ((1 << n_bits) - 1), n_bits)
    payload, off = writer.finalize()
    state = tuple(s - C.U_STATES for s in states)
    return payload, LiteralParam(num=n, n_payload_bytes=len(payload),
                                 bits=off, state=state)


# --- LMD stream ---------------------------------------------------------------------

def decode_lmds(payload: bytes, tables: DecoderTables,
                param: LmdParam) -> np.ndarray:
    """Decode the 3-way interleaved L/M/D stream into an (n, 3) int32 array.

    The distances are *packed* (zero = repeat previous). Reference:
    lmds.rs:27-60. `payload` includes its own 8-byte leading pad.
    """
    reader = BitReader(payload, param.bits)
    v_tab = tables.v
    sl, sm, sd = param.state
    sm += C.L_STATES
    sd += C.L_STATES + C.M_STATES
    out = np.empty((param.num, 3), dtype=np.int32)
    pull = reader.pull
    for i in range(param.num):
        k, v_bits, delta, v_base = (int(x) for x in v_tab[sl])
        sl = pull(k) + delta
        l = v_base + pull(v_bits)
        k, v_bits, delta, v_base = (int(x) for x in v_tab[sm])
        sm = pull(k) + delta
        m = v_base + pull(v_bits)
        k, v_bits, delta, v_base = (int(x) for x in v_tab[sd])
        sd = pull(k) + delta
        d = v_base + pull(v_bits)
        out[i] = (l, m, d)
    reader.finalize()
    if (sl, sm, sd) != (0, C.L_STATES, C.L_STATES + C.M_STATES):
        raise FseError("BadLmdPayload", "lmd final state")
    return out


def encode_lmds(lmds: np.ndarray, etables: EncoderTables) -> tuple[bytes, LmdParam]:
    """Encode packed LMD rows in reverse D,M,L order (lmds.rs:62-93).

    Returns the payload *including* the 8-byte leading zero pad.
    """
    writer = BitWriter()
    push = writer.push
    sl, sm, sd = C.L_STATES, C.M_STATES, C.D_STATES

    def push_value(v: int, state: int, extra_bits, base_from_value, base_value,
                   e_tab) -> int:
        sym = int(base_from_value[v])
        nb = int(extra_bits[sym])
        push(v - int(base_value[sym]), nb)
        t_k, t_w = int(e_tab[sym, 0]), int(e_tab[sym, 1])
        n_bits = (t_k + state) >> 10
        push(state & ((1 << n_bits) - 1), n_bits)
        return t_w + (state >> n_bits)

    for i in range(len(lmds) - 1, -1, -1):
        l, m, d = (int(x) for x in lmds[i])
        d_idx = int(C.d_index(d))
        sym = int(C.D_BASE_FROM_VALUE[d_idx])
        push(d - int(C.D_BASE_VALUE[sym]), int(C.D_EXTRA_BITS[sym]))
        t_k, t_w = int(etables.d[sym, 0]), int(etables.d[sym, 1])
        n_bits = (t_k + sd) >> 10
        push(sd & ((1 << n_bits) - 1), n_bits)
        sd = t_w + (sd >> n_bits)
        sm = push_value(m, sm, C.M_EXTRA_BITS, C.M_BASE_FROM_VALUE,
                        C.M_BASE_VALUE, etables.m)
        sl = push_value(l, sl, C.L_EXTRA_BITS, C.L_BASE_FROM_VALUE,
                        C.L_BASE_VALUE, etables.l)
    payload, off = writer.finalize()
    state = (sl - C.L_STATES, sm - C.M_STATES, sd - C.D_STATES)
    return b"\x00" * 8 + payload, LmdParam(
        num=len(lmds), n_payload_bytes=len(payload) + 8, bits=off, state=state)


# --- Whole-block assembly (encode) --------------------------------------------------

def _group_scan(lmds: np.ndarray):
    """Vectorized logical-match scan for the period-split rule. Returns
    (d_eff per row, group id per row, group total m, group d_eff,
    group sizes, eligible-group mask). A logical match is a row plus its
    continuation rows (l == 0, stored d == 0 — the MAX_M chunking)."""
    n = len(lmds)
    l = lmds[:, 0].astype(np.int64)
    m = lmds[:, 1].astype(np.int64)
    d = lmds[:, 2].astype(np.int64)
    idx = np.maximum.accumulate(np.where(d > 0, np.arange(n), -1))
    d_eff = np.where(idx >= 0, d[np.maximum(idx, 0)], 0)
    start = (l > 0) | (d > 0)
    if n:
        start[0] = True
    gid = np.cumsum(start) - 1
    n_g = int(gid[-1]) + 1 if n else 0
    tm = np.bincount(gid, weights=m, minlength=n_g).astype(np.int64)
    gde = d_eff[start]
    gsz = np.bincount(gid, minlength=n_g).astype(np.int64)
    elig = (gde >= 4) & (gde <= 15) & (tm > gde)
    return d_eff, gid, tm, gde, gsz, elig


def period_split_eligible(lmds: np.ndarray) -> bool:
    """True when a block's rows have a period-split candidate (mirrors
    FseBackend::period_split's gate): some logical match has running
    distance in [4, 15] and total length > distance, and the expansion
    fits LMDS_PER_BLOCK."""
    if not len(lmds):
        return False
    _, _, tm, gde, gsz, elig = _group_scan(np.asarray(lmds, np.int64)
                                           .reshape(-1, 3))
    if not elig.any():
        return False
    pieces = np.where(elig, -(-tm // np.maximum(gde, 1)), gsz)
    return int(pieces.sum()) <= C.LMDS_PER_BLOCK


def period_split_rows(lmds: np.ndarray):
    """The period-split candidate rows, or None when ineligible. Mirrors
    FseBackend::period_split exactly: each eligible logical match
    (running distance d in [4, 15], total length > d) re-emits as
    total//d pieces of length d (zero-extra-bit direct M symbols +
    repeat-D rows) plus one remainder piece; everything else passes
    through. Decode-equivalent by the period-copy semantics."""
    lmds = np.asarray(lmds, np.int32).reshape(-1, 3)
    if not period_split_eligible(lmds):
        return None
    out = []
    dist = 0
    n = len(lmds)
    i = 0
    while i < n:
        l, m, d = (int(x) for x in lmds[i])
        de = d if d else dist
        if d:
            dist = d
        j = i + 1
        mm = m
        while j < n and lmds[j, 0] == 0 and lmds[j, 2] == 0:
            mm += int(lmds[j, 1])
            j += 1
        if not (4 <= de <= 15 and mm > de):
            out.extend(map(tuple, lmds[i:j].tolist()))
        else:
            out.append((l, de, d))
            mm -= de
            while mm >= de:
                out.append((0, de, 0))
                mm -= de
            if mm:
                out.append((0, mm, 0))
        i = j
    return np.array(out, np.int32).reshape(-1, 3)


def encode_block(literals: np.ndarray, lmds: np.ndarray, n_raw_bytes: int) -> bytes:
    """Emit one complete Vx2 block: the smaller of the as-is rows and the
    period-split candidate (ties keep as-is) — the single emission
    decision point, mirroring FseBackend::emit_best."""
    alt = period_split_rows(lmds)
    if alt is None:
        return _encode_block_raw(literals, lmds, n_raw_bytes)
    a = _encode_block_raw(literals, lmds, n_raw_bytes)
    b = _encode_block_raw(literals, alt, n_raw_bytes)
    return b if len(b) < len(a) else a


def _encode_block_raw(literals: np.ndarray, lmds: np.ndarray,
                      n_raw_bytes: int) -> bytes:
    """Emit one complete Vx2 block from padded literals and packed LMD rows.

    Mirrors FseBackend::emit_block_v2 (fse/backend.rs:39-54): weights from the
    un-padded content, pad literals to 4 with literals[0] (or 0 when empty),
    then header | weights | literal payload | lmd payload.
    """
    n_lit = len(literals)
    pad = (-n_lit) % 4
    pad_byte = literals[0] if n_lit else np.uint8(0)
    padded = np.concatenate([literals, np.full(pad, pad_byte, dtype=np.uint8)])
    weights = W.weights_from_block(lmds, literals)
    weight_payload = W.store_v2(weights)
    etables = EncoderTables(weights)
    lit_payload, lit_param = encode_literals(padded, etables)
    lmd_payload, lmd_param = encode_lmds(lmds, etables)
    block = FseBlock(lit_param, lmd_param, n_raw_bytes)
    header = store_v2_header(block, len(weight_payload))
    return header + weight_payload + lit_payload + lmd_payload
