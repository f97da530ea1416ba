"""Helpers shared by the port's tests: parse corpus containers into FSE
blocks and build the port's decode kernel arguments from them; split raw
sources into the native frontend's blocks and stage them as the encode
kernels take them; build match-finder windows and group their positions;
read a bytes object's buffer address. Imports no JAX, so the tests that run on a card can use it."""

import ctypes

import numpy as np
import torch

from lzfse_rust_tpu_torch.base import constants as C
from lzfse_rust_tpu_torch.models.decoder import _parse_container
from lzfse_rust_tpu_torch.models.encoder import _parse_blocks
from lzfse_rust_tpu_torch.ops import cuda_decode as K
from lzfse_rust_tpu_torch.runtime.build import native_runtime

LMD_OFF = (0, C.L_STATES, C.L_STATES + C.M_STATES)

_PyBytes_AsString = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def bytes_addr(b: bytes) -> int:
    """The address of a bytes object's buffer (``PyBytes_AsString``)."""
    return _PyBytes_AsString(b)


def blocks_of(pairs):
    """Every FSE block of the containers, as the decoders parse them."""
    out: list = []
    for ci, (_, c) in enumerate(pairs):
        _parse_container(c, ci, out)
    return out


def tables_of(weights: list) -> tuple:
    """u3, v (n, 384) int32 via the native table build; tot as the JAX
    decoder computes it."""
    n = len(weights)
    w16 = np.ascontiguousarray(np.stack(weights), np.uint16)
    u3 = np.zeros((n, 384), np.int32)
    v = np.zeros((n, 384), np.int32)
    ident = np.arange(n, dtype=np.int32)
    native_runtime().build_tables3_batch(w16, ident, ident, v, u3,
                                         np.zeros(n, np.int32))
    tot = w16[:, C.D_TOP:C.U_TOP].sum(axis=1, dtype=np.int64).astype(np.int32)
    return u3, v, tot


def port_args(blocks, kind):
    """Port kernel arguments built straight from parsed blocks (payloads
    concatenated at 4-byte boundaries)."""
    u3, v, tot = tables_of([d.weights for d in blocks])
    pays = [d.lit_payload if kind == "literals" else d.lmd_payload
            for d in blocks]
    params = [d.block.literal if kind == "literals" else d.block.lmd
              for d in blocks]
    lens = np.array([-(-len(p) // 4) for p in pays])
    off = np.concatenate(([0], np.cumsum(lens)[:-1]))
    cat = b"".join(p + b"\0" * (4 * n - len(p)) for p, n in zip(pays, lens))
    num = np.array([p.num for p in params])
    counts = K.literal_counts(num) if kind == "literals" else num
    out_off, n_out = K.out_offsets(counts)
    if kind == "literals":
        states = np.array([p.state for p in params])
    else:
        states = np.array([[s + o for s, o in zip(p.state, LMD_OFF)]
                           for p in params])
    i32 = lambda x: torch.from_numpy(np.array(x, np.int32))  # noqa: E731
    args = dict(tables=i32(u3 if kind == "literals" else v),
                words=i32(np.frombuffer(cat, "<i4")), word_off=i32(off),
                word_len=i32(lens), states=i32(states),
                pos=i32([len(p) * 8 - q.bits for p, q in zip(pays, params)]),
                num=i32(num), out_off=i32(out_off), n_out=n_out)
    if kind == "literals":
        args["tot"] = i32(tot)
    return args, out_off


def encode_blocks(sources) -> list:
    """The native frontend's blocks of each source, in order:
    ``(lits u8[], rows3 (n, 3) int32, n_match_bytes, weights (360,) int64)``
    with the block's normalized weights."""
    nat = native_runtime()
    out = []
    for src in sources:
        for lits, rows3, n_mb in _parse_blocks(nat.frontend_blocks(src)):
            w, _ = nat.block_weights(rows3, lits)
            out.append((lits, rows3, n_mb, w.astype(np.int64)))
    return out


def encode_rows(blocks, n_cols: int, n_rows: int | None = None) -> dict:
    """Blocks staged as the encode kernels read them (numpy): ``weights``
    (B, 360) int64; right-justified ``words`` (literals padded to a multiple
    of 4 with the first literal, 4 per int32), ``lm = l | m << 16`` and
    ``d`` (B, n_cols) int32; counts ``lit_num`` (padded) and ``lmd_num``.
    Rows past the blocks (up to ``n_rows``) are empty."""
    B = len(blocks) if n_rows is None else n_rows
    st = dict(weights=np.zeros((B, C.N_WEIGHTS), np.int64),
              litw=np.zeros((B, n_cols * 4), np.uint8),
              lm=np.zeros((B, n_cols), np.int32),
              d=np.zeros((B, n_cols), np.int32),
              lit_num=np.zeros(B, np.int32), lmd_num=np.zeros(B, np.int32))
    for i, (lits, rows3, _, w) in enumerate(blocks):
        st["weights"][i] = w
        pad = (-len(lits)) % 4
        padded = np.concatenate([lits, np.full(pad, lits[0] if len(lits)
                                               else 0, np.uint8)])
        st["litw"][i, n_cols * 4 - len(padded):] = padded
        st["lit_num"][i] = len(padded)
        nr = len(rows3)
        st["lm"][i, n_cols - nr:] = rows3[:, 0] | (rows3[:, 1] << 16)
        st["d"][i, n_cols - nr:] = rows3[:, 2]
        st["lmd_num"][i] = nr
    st["words"] = st.pop("litw").view("<i4")
    return st


def words(rng, n_words: int, vocab: int = 16) -> bytes:
    """n_words seeded words of 2-6 letters from a vocabulary of ``vocab``,
    joined by spaces."""
    vocab_ = [bytes(rng.integers(97, 110, int(rng.integers(2, 7)),
                                 dtype=np.uint8)) for _ in range(vocab)]
    return b" ".join(vocab_[int(i)] for i in rng.integers(0, vocab, n_words))


def window_rows(N: int, seed: int) -> list:
    """(bytes, n_real, lo, hi) of one window each: words with a cut
    payload, a 300-byte block repeated (runs past 64 bytes), a tail that
    repeats an earlier 40-byte string up to n_real, random bytes, an
    all-zero row, and n_real 3 and 0."""
    rng = np.random.default_rng(seed)
    n = N - 128
    text = words(rng, N)[:n]
    block = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    head = bytes(rng.integers(0, 256, N // 2, dtype=np.uint8))
    tail = head + head[100:140]
    return [(text, n, 57, n - 31),
            ((block * (N // 300 + 1))[:N - 200], N - 200, 0, N - 200),
            (tail, len(tail), 5, len(tail)),
            (bytes(rng.integers(0, 256, n, dtype=np.uint8)), n, 0, N),
            (bytes(n), n, 0, n),
            (b"abc", 3, 0, 3),
            (b"", 0, 0, 0)]


def grouped_inputs(rows, N: int, vn: bool, match_group) -> dict:
    """grouped_compact's numpy arguments, grouped by ``match_group``."""
    B = len(rows)
    a = dict(pads=np.zeros((B, N), np.uint8), n_reals=np.zeros(B, np.int32),
             los=np.zeros(B, np.int32), his=np.zeros(B, np.int32),
             orders=np.zeros((B, N), np.int32), oks=np.zeros((B, N), np.uint8))
    for r, (data, n, lo, hi) in enumerate(rows):
        a["pads"][r, :len(data)] = np.frombuffer(data, np.uint8)
        a["n_reals"][r], a["los"][r], a["his"][r] = n, lo, hi
        a["orders"][r], a["oks"][r] = match_group(a["pads"][r], n, vn)
    return a


REBUILD_CASES = ("overlap", "d1_runs", "d_eq_m", "padding", "empty",
                 "bad_distance", "too_many_literals", "total_mismatch")


def rebuild_case(name: str, seed: int, B: int = 6, R: int = 24, L: int = 96,
                 n_out: int = 1024):
    """Seeded ``lz_rebuild_batch`` arguments (numpy, the JAX padded layout):
    (literals (B, L) uint8, rows (B, R, 3) int32, n_raw (B,) int32, n_out).

    Every case has valid containers of rows with self-overlapping matches
    (d < m) and its own feature: ``d1_runs`` long d = 1 runs, ``d_eq_m`` d =
    m or m - 1 at every match row, ``padding`` mostly padding rows,
    ``empty`` containers without rows; and one broken container:
    ``bad_distance`` a d past the bytes made so far (and a d = 0 match),
    ``too_many_literals`` rows that consume more literals than L,
    ``total_mismatch`` an n_raw one off the rows' total."""
    rng = np.random.default_rng(seed)
    lits = rng.integers(0, 256, (B, L), dtype=np.uint8)
    rows = np.zeros((B, R, 3), np.int32)
    n_raw = np.zeros(B, np.int32)
    for b in range(B):
        n_rows = int(rng.integers(1, 4 if name == "padding" else R + 1))
        if name == "empty" and b % 2 == 0:
            n_rows = 0
        out = used = 0
        for r in range(n_rows):
            l = min(int(rng.integers(0 if out else 1, 8)), L - used)
            made = out + l
            m = int(rng.integers(3, 40)) if made else 0
            if name == "d1_runs" and made:
                m, d = int(rng.integers(100, 300)), 1
            elif name == "d_eq_m" and made:
                m = min(m, made + 1)
                d = m if m <= made else m - 1
                d -= int(rng.integers(0, 2)) if d > 1 else 0
            else:
                d = int(rng.integers(1, min(made, m) + 1)) if made else 0
            if made + m > n_out:
                break
            rows[b, r] = (l, m, d)
            out, used = made + m, used + l
        n_raw[b] = out
    k = B // 2
    if name == "bad_distance":
        rows[k, 0] = (2, 5, 3)
        rows[k + 1, 1, 2] = 0
        rows[k + 1, 1, 1] = max(rows[k + 1, 1, 1], 1)
        n_raw[k] = rows[k, :, :2].sum()
        n_raw[k + 1] = rows[k + 1, :, :2].sum()
    elif name == "too_many_literals":
        rows[k, 0, 0] += L
        n_raw[k] = rows[k, :, :2].sum()
    elif name == "total_mismatch":
        n_raw[k] += 1
    return lits, rows, n_raw, n_out


def chunk_spans(device: str, raws, monkeypatch) -> list:
    """The slot spans [s0, s1) of the chunks ``TorchEncoder(device)``
    emits for ``raws`` under the ``LZT_ENC_CHUNKS`` already set, recorded
    by a spy on ``_emit_chunk`` that stays in place (``monkeypatch``)."""
    from lzfse_rust_tpu_torch.models import encoder as M
    spans: list = []
    real = M.TorchEncoder._emit_chunk

    def spy(self, pool, s0, s1, clock):
        spans.append((s0, s1))
        return real(self, pool, s0, s1, clock)

    monkeypatch.setattr(M.TorchEncoder, "_emit_chunk", spy)
    M.TorchEncoder(device).encode_many(raws)
    return spans


def overflow_in_second_chunk(device: str, raws, monkeypatch):
    """Encode ``raws`` with a staging pool that holds the first chunk's
    slots and one more, so the second chunk's frontends overflow it.
    Returns (containers, pool sizes asked, chunk spans emitted in order,
    the chunk spans of an encode with a large pool)."""
    from lzfse_rust_tpu_torch.models import encoder as M
    spans = chunk_spans(device, raws, monkeypatch)
    first = list(spans)
    assert len(first) >= 2 and first[1][1] - first[1][0] >= 2, first
    spans.clear()
    bound = first[0][1] + 1
    asked: list = []
    real = M.TorchEncoder._staging

    def staging(self, slots):
        asked.append(slots)
        return real(self, slots)

    monkeypatch.setattr(M.TorchEncoder, "_staging", staging)
    monkeypatch.setattr(M, "_slot_bound", lambda sources, big: bound)
    monkeypatch.setattr(M, "_round_up", lambda n, step: n)
    out = M.TorchEncoder(device).encode_many(raws)
    return out, asked, list(spans), first
