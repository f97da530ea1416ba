"""FSE weight tables: histogram, normalization, and the V2 Huffman weight codec.

A weight table is a single int array of N_WEIGHTS=360 entries laid out
[ L(20) | M(20) | D(64) | U(256) ]. Each sub-block is normalized so its total
is exactly its state count (64/64/256/1024) — or all-zero when the block has no
symbols of that class. Reference: src/fse/weights.rs.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .errors import FseError


# --- V2 compressed weight payload (static Huffman varint code) ----------------------

def decode_weight(u: int) -> tuple[int, int]:
    """Decode one weight from the low bits of `u`. Returns (weight, n_bits).

    Reference: src/fse/weight_encoder.rs:10-20.
    """
    index = u & 0x1F
    u_bits = int(C.WEIGHTS_BITS_TABLE[index])
    if u_bits == 8:
        w = 8 + ((u >> 4) & 0xF)
    elif u_bits == 14:
        w = 24 + ((u >> 4) & 0x3FF)
    else:
        w = int(C.WEIGHTS_VALUE_TABLE[index])
    return w, u_bits


def encode_weight(w: int) -> tuple[int, int]:
    """Encode one weight. Returns (code, n_bits). Reference: weight_encoder.rs:23-37."""
    assert w < 1048
    SMALL = {0: (0, 2), 1: (2, 2), 2: (1, 3), 3: (5, 3),
             4: (3, 5), 5: (11, 5), 6: (19, 5), 7: (27, 5)}
    if w in SMALL:
        return SMALL[w]
    if w < 24:
        return ((w - 8) << 4) + 7, 8
    return ((w - 24) << 4) + 15, 14


def load_v2(src: bytes) -> np.ndarray:
    """Decode a V2 compressed weight payload into a 360-entry weight array.

    Exact model of Weights::load_v2 (weights.rs:83-105): an LSB-first forward
    accumulator that refills while <= 24 bits are held, with strict
    under/overflow accounting.
    """
    weights = np.zeros(C.N_WEIGHTS, dtype=np.int64)
    accum = 0
    accum_bits = 0
    i = 0
    n = len(src)
    for k in range(C.N_WEIGHTS):
        while i != n and accum_bits <= 24:
            accum |= src[i] << accum_bits
            accum_bits += 8
            i += 1
        w, w_bits = decode_weight(accum)
        weights[k] = w
        accum >>= w_bits
        accum_bits -= w_bits
    if accum_bits < 0:
        raise FseError("WeightPayloadUnderflow")
    if accum_bits >= 8 or i != n:
        raise FseError("WeightPayloadOverflow")
    check_totals(weights)
    return weights


def store_v2(weights: np.ndarray) -> bytes:
    """Encode a weight array as a V2 compressed payload (weights.rs:139-163)."""
    out = bytearray()
    accum = 0
    accum_bits = 0
    for w in weights:
        u, u_bits = encode_weight(int(w))
        accum |= u << accum_bits
        accum_bits += u_bits
        while accum_bits >= 8:
            out.append(accum & 0xFF)
            accum >>= 8
            accum_bits -= 8
    if accum_bits > 0:
        out.append(accum & 0xFF)
    return bytes(out)


def load_v1(src: bytes) -> np.ndarray:
    """Decode a V1 raw u16 weight payload (weights.rs:66-80)."""
    if len(src) < C.V1_WEIGHT_PAYLOAD_BYTES:
        raise FseError("WeightPayloadUnderflow")
    if len(src) > C.V1_WEIGHT_PAYLOAD_BYTES:
        raise FseError("WeightPayloadOverflow")
    weights = np.frombuffer(src[:C.N_WEIGHTS * 2], dtype="<u2").astype(np.int64)
    check_totals(weights)
    return weights


def store_v1(weights: np.ndarray) -> bytes:
    out = weights.astype("<u2").tobytes()
    return out + b"\x00" * (C.V1_WEIGHT_PAYLOAD_BYTES - len(out))


def check_totals(weights: np.ndarray) -> None:
    """Reject weight tables whose sub-block totals exceed their state counts
    (weights.rs:189-200)."""
    if (weights[:C.L_TOP].sum() > C.L_STATES
            or weights[C.L_TOP:C.M_TOP].sum() > C.M_STATES
            or weights[C.M_TOP:C.D_TOP].sum() > C.D_STATES
            or weights[C.D_TOP:C.U_TOP].sum() > C.U_STATES):
        raise FseError("BadWeightPayload")


# --- Normalization ------------------------------------------------------------------

def normalize_m1(weights: np.ndarray, in_total: int, out_total: int) -> None:
    """Normalize `weights` in place so it sums to exactly `out_total`.

    Exact integer model of the reference's scaled-multiply coarse pass with
    remainder dump on the max symbol or trim fallback (weights.rs:218-278).
    Nonzero input weights stay nonzero.
    """
    assert out_total & (out_total - 1) == 0 and out_total <= 0x40000000
    if in_total == 0:
        return
    shift = 32 - out_total.bit_length()  # == u32 leading_zeros(out_total)
    multiply = (1 << 31) // in_total
    round_ = 1 << (shift - 1)
    nz = weights != 0
    f = (weights * multiply + round_) >> shift
    f = np.where(nz & (f == 0), 1, f)
    f = np.where(nz, f, 0)
    weights[:] = f
    remaining = out_total - int(f.sum())
    max_index = int(np.argmax(f)) if nz.any() else 0
    # argmax ties: reference keeps the FIRST index achieving the max via
    # strict `>` updates — np.argmax also returns the first. But the reference
    # only considers nonzero entries, which is equivalent since zeros can't win
    # unless all are zero (handled above).
    if -remaining < int(weights[max_index]) // 4:
        weights[max_index] += remaining
    else:
        _trim(weights, -remaining)


def _trim(weights: np.ndarray, overflow: int) -> None:
    """Remove `overflow` total weight, largest-shares first (weights.rs:263-278)."""
    for shift in (3, 2, 1, 0):
        for i in range(len(weights)):
            if overflow == 0:
                return
            w = int(weights[i])
            if w == 0:
                continue
            n = min((w - 1) >> shift, overflow)
            weights[i] = w - n
            overflow -= n
    assert overflow == 0


# --- Histogram build (encode side) --------------------------------------------------

def weights_from_block(lmds: np.ndarray, literals: np.ndarray) -> np.ndarray:
    """Build the normalized weight table for one block.

    `lmds` is an (n, 3) int array of packed (literal_len, match_len,
    match_distance_zeroed) rows; `literals` is a uint8 array. Mirrors
    Weights::load (weights.rs:25-64).
    """
    weights = np.zeros(C.N_WEIGHTS, dtype=np.int64)
    n_lmds = len(lmds)
    if n_lmds:
        l_sym = C.L_BASE_FROM_VALUE[lmds[:, 0]]
        m_sym = C.M_BASE_FROM_VALUE[lmds[:, 1]]
        d_sym = C.D_BASE_FROM_VALUE[C.d_index(lmds[:, 2])]
        np.add.at(weights, l_sym, 1)
        np.add.at(weights, C.L_TOP + m_sym, 1)
        np.add.at(weights, C.M_TOP + d_sym, 1)
        normalize_m1(weights[:C.L_TOP], n_lmds, C.L_STATES)
        normalize_m1(weights[C.L_TOP:C.M_TOP], n_lmds, C.M_STATES)
        normalize_m1(weights[C.M_TOP:C.D_TOP], n_lmds, C.D_STATES)
    if len(literals):
        np.add.at(weights, C.D_TOP + literals.astype(np.int64), 1)
        normalize_m1(weights[C.D_TOP:C.U_TOP], len(literals), C.U_STATES)
    return weights
