"""tANS table construction for decode (V/U entries) and encode (E entries).

Decode tables: one entry per *state*. A V entry (L/M/D classes) holds
(k, v_bits, delta, v_base); decoding pulls k state bits to form the next state
(plus delta) and v_bits extra bits to form the value (v_base + extra).
A U entry (literals) holds (k, symbol, delta). Reference: src/fse/decoder.rs.

Encode tables: one entry per *symbol*, (t_k, t_w), driving the branchless state
update  n_bits = (t_k + state) >> 10 ;  state' = t_w + (state >> n_bits).
Reference: src/fse/encoder.rs:182-240.

States out of the normalized total are configured as self-latching so
adversarial payloads converge to a detectable invalid state instead of reading
out of bounds (decoder.rs:283-291).
"""

from __future__ import annotations

import numpy as np

from . import constants as C

# Structured layouts (kept as parallel arrays for numpy/JAX friendliness).
# v_table columns: k, v_bits, delta, v_base
# u_table columns: k, symbol, delta
# e_table columns: t_k, t_w


def build_v_table_block(weights: np.ndarray, v_bits_table: np.ndarray,
                        v_base_table: np.ndarray, n_states: int,
                        offset: int) -> np.ndarray:
    """Build an (n_states, 4) int32 decode table block (decoder.rs:244-292)."""
    table = np.zeros((n_states, 4), dtype=np.int32)
    n_bits = n_states.bit_length() - 1  # log2
    total = 0
    for i, w in enumerate(weights):
        w = int(w)
        if w == 0:
            continue
        k = n_states.bit_length() - w.bit_length()  # clz(w) - clz(n_states)
        x = ((n_states << 1) >> k) - w
        v_bits = int(v_bits_table[i])
        v_base = int(v_base_table[i])
        for j in range(x):
            delta = ((w + j) << k) - n_states + offset
            table[total + j] = (k, v_bits, delta, v_base)
        for j in range(x, w):
            delta = ((j - x) << (k - 1)) + offset
            table[total + j] = (k - 1, v_bits, delta, v_base)
        total += w
    # Latch entries for unpopulated (reachable only on malicious input) states.
    for s in range(total, n_states):
        table[s] = (0, 0, offset + s, 0)
    return table


def build_u_table(weights: np.ndarray, n_states: int) -> np.ndarray:
    """Build an (n_states, 3) int32 literal decode table (decoder.rs:299-335)."""
    table = np.zeros((n_states, 3), dtype=np.int32)
    total = 0
    for i, w in enumerate(weights):
        w = int(w)
        if w == 0:
            continue
        k = n_states.bit_length() - w.bit_length()
        x = ((n_states << 1) >> k) - w
        for j in range(x):
            delta = ((w + j) << k) - n_states
            table[total + j] = (k, i, delta)
        for j in range(x, w):
            delta = ((j - x) << (k - 1))
            table[total + j] = (k - 1, i, delta)
        total += w
    for s in range(total, n_states):
        table[s] = (0, 0, s)
    return table


class DecoderTables:
    """Combined decode tables for one block: v_table (384, 4) + u_table (1024, 3).

    v_table state layout matches the reference's compound indexing: L states at
    offset 0, M at 64, D at 128..384; `delta` values already include the offset.
    """

    __slots__ = ("v", "u")

    def __init__(self, weights: np.ndarray):
        l_blk = build_v_table_block(weights[:C.L_TOP], C.L_EXTRA_BITS,
                                    C.L_BASE_VALUE, C.L_STATES, 0)
        m_blk = build_v_table_block(weights[C.L_TOP:C.M_TOP], C.M_EXTRA_BITS,
                                    C.M_BASE_VALUE, C.M_STATES, C.L_STATES)
        d_blk = build_v_table_block(weights[C.M_TOP:C.D_TOP], C.D_EXTRA_BITS,
                                    C.D_BASE_VALUE, C.D_STATES,
                                    C.L_STATES + C.M_STATES)
        self.v = np.concatenate([l_blk, m_blk, d_blk], axis=0)
        self.u = build_u_table(weights[C.D_TOP:C.U_TOP], C.U_STATES)


def build_e_table(weights: np.ndarray, n_states: int) -> np.ndarray:
    """Build an (n_symbols, 2) int32 encode table (encoder.rs:216-240)."""
    table = np.zeros((len(weights), 2), dtype=np.int32)
    total = 0
    for i, w in enumerate(weights):
        w = int(w)
        if w == 0:
            table[i] = (-n_states, 0)
        else:
            k = n_states.bit_length() - w.bit_length()
            table[i] = (1024 * k - (w << k), n_states + total - w)
        total += w
    return table


class EncoderTables:
    """Per-symbol encode tables for one block."""

    __slots__ = ("l", "m", "d", "u")

    def __init__(self, weights: np.ndarray):
        self.l = build_e_table(weights[:C.L_TOP], C.L_STATES)
        self.m = build_e_table(weights[C.L_TOP:C.M_TOP], C.M_STATES)
        self.d = build_e_table(weights[C.M_TOP:C.D_TOP], C.D_STATES)
        self.u = build_e_table(weights[C.D_TOP:C.U_TOP], C.U_STATES)
