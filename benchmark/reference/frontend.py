"""Encoder frontend — greedy/lazy match selection and block emission.

Consumes the vectorized match stream (match_find.py) through the exact
sequential selection semantics of the reference hot loop
(frontend_bytes.rs:160-211 driving Match::select, match_object.rs:12-33), then
routes literals/matches into the FSE or LZVN backends with the reference's
block-splitting rules (fse/buffer.rs:44-117, vn/backend.rs:37-135).

Block-type selection (frontend_bytes.rs:63-77 + constants):
    len <= 0x14   -> Raw
    len <= 0x1000 -> LZVN (reworked to Raw if not smaller, :92-99)
    else          -> FSE (Vx2)
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .match_find import MatchStream, find_matches
from .vn import VnEncoder


def select_matches(stream: MatchStream, n: int) -> list[tuple[int, int, int]]:
    """Sequential pending/incoming arbitration over the candidate stream.

    Returns emitted matches as (idx, match_idx, match_len) with backward
    extension applied, in emission order. Exact model of the hot loop:
    after each emission, candidate positions below the new literal_index are
    skipped (sync_history path, frontend_bytes.rs:191-199), and the loop exits
    once literal_index reaches the probe limit (n - 3).
    """
    out: list[tuple[int, int, int]] = []
    pending = None  # (idx, match_idx, len)
    literal_index = 0
    limit = n - 3  # probe loop bound (self.index, frontend_bytes.rs:173)
    min_index = 0  # next probe position
    good = C.GOOD_MATCH_LEN

    pos_arr = stream.pos
    for i in range(len(pos_arr)):
        p = int(pos_arr[i])
        if p < min_index:
            continue
        # Backward extension capped by the current literal boundary
        # (frontend_bytes.rs:261-268: max = min(literal_len, match_index)).
        ext = min(int(stream.back_max[i]), p - literal_index)
        inc_idx = p - ext
        inc_match_idx = int(stream.match_pos[i]) - ext
        inc_len = int(stream.fwd_len[i]) + ext

        # Match::select (match_object.rs:12-33). incoming.match_len != 0 here.
        if inc_len >= good:
            emit = (inc_idx, inc_match_idx, inc_len)
            pending = None
        elif pending is None:
            pending = (inc_idx, inc_match_idx, inc_len)
            continue
        elif pending[0] + pending[2] <= inc_idx:
            emit = pending
            pending = (inc_idx, inc_match_idx, inc_len)
        elif inc_len > pending[2]:
            emit = (inc_idx, inc_match_idx, inc_len)
            pending = None
        else:
            emit = pending
            pending = None

        out.append(emit)
        literal_index = emit[0] + emit[2]
        if literal_index >= limit:
            pending = None  # loop breaks; pending was consumed or cleared
            break
        min_index = max(p + 1, literal_index)

    if pending is not None:
        out.append(pending)
    return out


class FseBuffer:
    """Block accumulator with the reference's exact splitting rules
    (fse/buffer.rs:44-117). Emits completed blocks via a callback."""

    def __init__(self, src: np.ndarray, emit_block):
        self.src = src
        self.emit_block = emit_block  # fn(literals: np.ndarray, lmds, n_raw)
        self.lit_parts: list[tuple[int, int]] = []  # (start, end) into src
        self.n_lit = 0
        self.lmds: list[tuple[int, int, int]] = []
        self.n_match_bytes = 0
        self.match_distance = 0

    def _reset(self):
        self.lit_parts = []
        self.n_lit = 0
        self.lmds = []
        self.n_match_bytes = 0
        self.match_distance = 0

    def _emit(self):
        literals = (np.concatenate(
            [self.src[s:e] for s, e in self.lit_parts])
            if self.lit_parts else np.zeros(0, dtype=np.uint8))
        lmds = np.array(self.lmds, dtype=np.int32).reshape(-1, 3)
        self.emit_block(literals, lmds, self.n_lit + self.n_match_bytes)
        self._reset()

    def _push_lits(self, start: int, n: int):
        self.lit_parts.append((start, start + n))
        self.n_lit += n

    def _push_l(self, l: int):
        self.match_distance = 1
        self.lmds.append((l, 0, 1))

    def _push_lmd(self, l: int, m: int, d: int):
        if self.match_distance == d:
            self.lmds.append((l, m, 0))
        else:
            self.lmds.append((l, m, d))
        self.match_distance = d
        self.n_match_bytes += m

    def push_match(self, lit_start: int, lit_len: int, match_len: int,
                   match_distance: int) -> None:
        """FseBackend::push_match — loop Buffer::push until accepted."""
        while True:
            done = self._push(lit_start, lit_len, match_len, match_distance)
            if done is True:
                return
            lit_start, lit_len, match_len = done
            self._emit()

    def push_literals(self, lit_start: int, lit_len: int) -> None:
        self.push_match(lit_start, lit_len, 0, 1)

    def finalize(self) -> None:
        self._emit()

    def _push(self, lit_start: int, lit_len: int, match_len: int,
              match_distance: int):
        """One Buffer::push attempt. Returns True when fully consumed, else
        (remaining_lit_start, remaining_lit_len, remaining_match_len)."""
        MAXL = C.MAX_L_VALUE
        MAXM = C.MAX_M_VALUE
        while lit_len > MAXL:
            if len(self.lmds) == C.LMDS_PER_BLOCK:
                return (lit_start, lit_len, match_len)
            limit = C.LITERALS_PER_BLOCK - self.n_lit
            if MAXL <= limit:
                self._push_lits(lit_start, MAXL)
                self._push_l(MAXL)
                lit_start += MAXL
                lit_len -= MAXL
            elif limit != 0:
                self._push_lits(lit_start, limit)
                self._push_l(limit)
                return (lit_start + limit, lit_len - limit, match_len)
            else:
                return (lit_start, lit_len, match_len)
        if len(self.lmds) == C.LMDS_PER_BLOCK:
            return (lit_start, lit_len, match_len)
        literal_len = lit_len
        limit = C.LITERALS_PER_BLOCK - self.n_lit
        if literal_len <= limit:
            self._push_lits(lit_start, literal_len)
            lit_start += literal_len
            lit_len = 0
        elif limit != 0:
            self._push_lits(lit_start, limit)
            self._push_l(limit)
            return (lit_start + limit, lit_len - limit, match_len)
        else:
            return (lit_start, lit_len, match_len)
        while match_len > MAXM:
            self._push_lmd(literal_len, MAXM, match_distance)
            match_len -= MAXM
            literal_len = 0
            if len(self.lmds) == C.LMDS_PER_BLOCK:
                return (lit_start, 0, match_len)
        self._push_lmd(literal_len, match_len, match_distance)
        return True


def emit_lmd_stream(src: np.ndarray, matches: list[tuple[int, int, int]],
                    backend) -> None:
    """Drive a backend from the selected match list (push_match/finalize of
    FrontendBytes::finalize, frontend_bytes.rs:121-131 + 287-332)."""
    literal_index = 0
    n = len(src)
    for idx, match_idx, match_len in matches:
        backend.push_match(literal_index, idx - literal_index, match_len,
                           idx - match_idx)
        literal_index = idx + match_len
    if literal_index < n:
        backend.push_literals(literal_index, n - literal_index)
    backend.finalize()


def encode_fse(src_bytes: bytes) -> bytes:
    """Encode as a sequence of Vx2 blocks (no container EOS)."""
    from . import fse as F
    src = np.frombuffer(src_bytes, dtype=np.uint8)
    stream = find_matches(src_bytes, vn=False)
    matches = select_matches(stream, len(src))
    chunks: list[bytes] = []

    def emit_block(literals, lmds, n_raw):
        chunks.append(F.encode_block(literals, lmds, n_raw))

    buffer = FseBuffer(src, emit_block)
    emit_lmd_stream(src, matches, buffer)
    return b"".join(chunks)


class _VnBackendAdapter:
    """Adapts VnEncoder to the (lit_start, lit_len, ...) backend interface."""

    def __init__(self, src: np.ndarray):
        self.src = src
        self.enc = VnEncoder()
        self.out: bytes | None = None

    def push_match(self, lit_start, lit_len, match_len, match_distance):
        lits = self.src[lit_start:lit_start + lit_len].tobytes()
        if match_len:
            self.enc.push_match(lits, match_len, match_distance)
        else:
            self.enc.push_literals(lits)

    def push_literals(self, lit_start, lit_len):
        self.enc.push_literals(self.src[lit_start:lit_start + lit_len].tobytes())

    def finalize(self):
        self.out = self.enc.finalize()


def encode_vn(src_bytes: bytes) -> bytes:
    """Encode as a single Vxn block (no container EOS)."""
    src = np.frombuffer(src_bytes, dtype=np.uint8)
    stream = find_matches(src_bytes, vn=True)
    matches = select_matches(stream, len(src))
    backend = _VnBackendAdapter(src)
    emit_lmd_stream(src, matches, backend)
    return backend.out


def encode_raw(src_bytes: bytes) -> bytes:
    """Encode as a single Raw block (no container EOS)."""
    return (C.MAGIC_RAW.to_bytes(4, "little")
            + len(src_bytes).to_bytes(4, "little") + src_bytes)


def encode_bytes(src: bytes) -> bytes:
    """One-shot container encode with the reference's block-type selection."""
    if len(src) > C.VN_CUTOFF:
        body = encode_fse(src)
    elif len(src) > C.RAW_CUTOFF:
        body = encode_vn(src)
        # VN-not-smaller-than-raw rework (frontend_bytes.rs:92-99).
        if (len(src) < C.RAW_LIMIT
                and len(src) + C.RAW_HEADER_SIZE <= len(body)):
            body = encode_raw(src)
    else:
        body = encode_raw(src)
    return body + C.MAGIC_EOS.to_bytes(4, "little")
