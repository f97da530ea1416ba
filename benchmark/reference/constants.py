"""Frozen LZFSE format constants (the "numerology").

These values define the LZFSE v2 container format and MUST NOT change: they are
format constants shared by every conforming implementation.

Reference spec: the reference's src/fse/constants.rs (symbol counts, state counts,
value caps, extra-bit/base-value tables), the reference's src/vn/constants.rs (LZVN
caps), the reference's src/encode/constants.rs (encoder cutoffs).

The large value->symbol lookup tables (L_BASE_FROM_VALUE and friends) are *derived*
here from the extra-bits/base-value tables, exactly as the reference's own self-tests
derive and verify them (constants.rs:386-460).
"""

from __future__ import annotations

import numpy as np

# --- Block magics (little-endian u32 of b"bvx?") ------------------------------------
# Reference: src/base/magic_bytes.rs:3-7
MAGIC_EOS = 0x24787662  # b"bvx$"
MAGIC_RAW = 0x2D787662  # b"bvx-"
MAGIC_VX1 = 0x31787662  # b"bvx1"
MAGIC_VX2 = 0x32787662  # b"bvx2"
MAGIC_VXN = 0x6E787662  # b"bvxn"

MAGICS = (MAGIC_EOS, MAGIC_RAW, MAGIC_VX1, MAGIC_VX2, MAGIC_VXN)

# --- FSE (tANS) block geometry ------------------------------------------------------
# Reference: src/fse/constants.rs:22-42
LMDS_PER_BLOCK = 10000
LITERALS_PER_BLOCK = 4 * LMDS_PER_BLOCK

L_SYMBOLS = 20
M_SYMBOLS = 20
D_SYMBOLS = 64
U_SYMBOLS = 256

MAX_L_BITS = 14
MAX_M_BITS = 17
MAX_D_BITS = 23
MAX_U_BITS = 10

L_STATES = 64
M_STATES = 64
D_STATES = 256
U_STATES = 1024

MAX_L_VALUE = 315
MAX_M_VALUE = 2359
MAX_D_VALUE = 262139

# Compound weight array layout: [ L | M | D | U ]
L_TOP = L_SYMBOLS
M_TOP = L_TOP + M_SYMBOLS
D_TOP = M_TOP + D_SYMBOLS
U_TOP = D_TOP + U_SYMBOLS
N_WEIGHTS = U_TOP  # 360

V1_HEADER_SIZE = 0x32
V2_HEADER_SIZE = 0x20
VN_HEADER_SIZE = 0x0C
RAW_HEADER_SIZE = 0x08

V1_WEIGHT_PAYLOAD_BYTES = N_WEIGHTS * 2 + 2
MAX_W_BITS = 14
V2_WEIGHT_PAYLOAD_BYTES_MAX = (N_WEIGHTS * MAX_W_BITS + 7) // 8

MAX_LMD_BITS = MAX_L_BITS + MAX_M_BITS + MAX_D_BITS
MAX_LMD_PAYLOAD = (MAX_LMD_BITS * LMDS_PER_BLOCK + 7) // 8 + 8
MAX_LITERAL_PAYLOAD = (MAX_U_BITS * LITERALS_PER_BLOCK + 7) // 8

V2_MAX_BLOCK_LEN = (
    V2_HEADER_SIZE + V2_WEIGHT_PAYLOAD_BYTES_MAX + MAX_LITERAL_PAYLOAD + MAX_LMD_PAYLOAD
)

# --- Weight Huffman code (static, for the V2 compressed weight table) ---------------
# Reference: src/fse/constants.rs:112-124
WEIGHTS_BITS_TABLE = np.array(
    [2, 3, 2, 5, 2, 3, 2, 8, 2, 3, 2, 5, 2, 3, 2, 14,
     2, 3, 2, 5, 2, 3, 2, 8, 2, 3, 2, 5, 2, 3, 2, 14], dtype=np.int32)

WEIGHTS_VALUE_TABLE = np.array(
    [0, 2, 1, 4, 0, 3, 1, -1, 0, 2, 1, 5, 0, 3, 1, -1,
     0, 2, 1, 6, 0, 3, 1, -1, 0, 2, 1, 7, 0, 3, 1, -1], dtype=np.int32)

# --- L/M/D value coding: extra bits + base values -----------------------------------
# Reference: src/fse/constants.rs:127-340
L_EXTRA_BITS = np.array(
    [0] * 16 + [2, 3, 5, 8], dtype=np.int32)
L_BASE_VALUE = np.array(
    list(range(16)) + [16, 20, 28, 60], dtype=np.int32)

M_EXTRA_BITS = np.array(
    [0] * 16 + [3, 5, 8, 11], dtype=np.int32)
M_BASE_VALUE = np.array(
    list(range(16)) + [16, 24, 56, 312], dtype=np.int32)

D_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
     4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
     8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11,
     12, 12, 12, 12, 13, 13, 13, 13, 14, 14, 14, 14, 15, 15, 15, 15], dtype=np.int32)
D_BASE_VALUE = np.array(
    [0, 1, 2, 3, 4, 6, 8, 10, 12, 16,
     20, 24, 28, 36, 44, 52, 60, 76, 92, 108,
     124, 156, 188, 220, 252, 316, 380, 444, 508, 636,
     764, 892, 1020, 1276, 1532, 1788, 2044, 2556, 3068, 3580,
     4092, 5116, 6140, 7164, 8188, 10236, 12284, 14332, 16380, 20476,
     24572, 28668, 32764, 40956, 49148, 57340, 65532, 81916, 98300, 114684,
     131068, 163836, 196604, 229372], dtype=np.int32)


def _derive_base_from_value(extra_bits: np.ndarray, base_value: np.ndarray,
                            max_value: int) -> np.ndarray:
    """Derive the value->symbol table from extra-bits/base-value spans.

    Mirrors the verification logic of the reference's self tests
    (src/fse/constants.rs:397-405): symbol i covers values
    [base_value[i], base_value[i] + 2**extra_bits[i]).
    """
    table = np.zeros(max_value + 1, dtype=np.int32)
    for i in range(len(extra_bits)):
        lo = int(base_value[i])
        hi = lo + (1 << int(extra_bits[i]))
        table[lo:hi] = i
    return table


L_BASE_FROM_VALUE = _derive_base_from_value(L_EXTRA_BITS, L_BASE_VALUE, MAX_L_VALUE)
M_BASE_FROM_VALUE = _derive_base_from_value(M_EXTRA_BITS, M_BASE_VALUE, MAX_M_VALUE)


def d_index(v) -> np.ndarray:
    """Bucket a match-distance value for D symbol lookup.

    Reference: src/fse/constants.rs:342-353. Works element-wise on arrays.
    """
    v = np.asarray(v, dtype=np.int64)
    return np.where(
        v < 60, v,
        np.where(v < 1020, ((v - 60) >> 4) + 64,
                 np.where(v < 16380, ((v - 1020) >> 8) + 128,
                          ((v - 16380) >> 12) + 192))).astype(np.int32)


def _derive_d_base_from_value() -> np.ndarray:
    """Derive the 256-entry d_index->symbol table (src/fse/constants.rs:324-340)."""
    table = np.zeros(256, dtype=np.int32)
    for i in range(D_SYMBOLS):
        lo = int(D_BASE_VALUE[i])
        hi = lo + (1 << int(D_EXTRA_BITS[i]))
        idxs = d_index(np.arange(lo, hi))
        table[np.unique(idxs)] = i
    return table


D_BASE_FROM_VALUE = _derive_d_base_from_value()

# --- LZVN constants -----------------------------------------------------------------
# Reference: src/vn/constants.rs
VN_MAX_L_VALUE = 271
VN_MAX_M_VALUE = 271
VN_MAX_D_VALUE = 65535
VN_EOS_BYTE = 0x06
VN_PAYLOAD_LIMIT = 0x2000

# --- Encoder tuning constants (match the reference encoder exactly) -----------------
# Reference: src/encode/constants.rs:3-10, src/encode/history.rs:10-13,
# src/encode/frontend_bytes.rs:20-23
GOOD_MATCH_LEN = 0x28
RAW_CUTOFF = 0x14
RAW_LIMIT = 0x4000
VN_CUTOFF = 0x1000
HASH_BITS = 14
HASH_WIDTH = 4
HASH_MUL = 0x9E3779B1  # Knuth multiplicative hash (src/fse/object.rs:38-43)
ENCODE_SLACK = 0x10000000
BLOCK_GUIDE = 0x7FFFFFFF
