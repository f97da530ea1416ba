"""LZ77 output reconstruction by pointer doubling, as torch ops.

Counterpart of ``lzfse_rust_tpu/ops/lz_rebuild.py``. Every output byte's
value is some literal byte, reached through a chain of "copy from distance d
back" links that strictly decrease the position, so composing the parent
map with itself resolves every byte in ceil(log2(n)) rounds. The decode sink
is continuous across a container's blocks, so each container's blocks are
flattened into one (l, m, d) row stream with one literal pool: FSE blocks
give their decoded rows (distances zero-substituted per block), LZVN blocks
their parsed rows, RAW blocks one all-literal row.

Three forms of the same function:

* ``lz_rebuild_batch``: the JAX package's padded layout, (B, R, 3) rows and
  (B, L) pools into (B, n_out) bytes, written as the JAX code is;
* ``lz_rebuild_flat``: the ragged layout the decoder builds on the card,
  each container's rows, pool and output a segment of one flat array. It is
  the plain version of the CUDA kernel of ``ops/cuda_rebuild.py``;
* ``flatten_pieces``: the decoder's device flatten, which makes the flat
  arguments from the decode kernels' dense outputs and the host-parsed
  LZVN/RAW rows.

Values that the JAX code keeps in int32 are int32 here, or int64 wrapped
to int32 (``_wrap32``) where the kernel's int32 arithmetic wraps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's range as int32 arithmetic wraps."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _last_nonzero(d: torch.Tensor):
    """(rank, value): along the last axis of ``d``, the count of nonzero
    entries at or before each position, and the last nonzero entry at or
    before it (0 where there is none). A cumulative count and a scatter by
    rank, not a running maximum: torch's cummax runs one long row on the
    card serially (35 ms for 12 M entries on the H100)."""
    nz = d != 0
    rank = torch.cumsum(nz, dim=-1)
    vals = torch.zeros(d.shape[:-1] + (d.shape[-1] + 1,), dtype=d.dtype,
                       device=d.device)
    # entries of zero d all land in slot 0, which no rank >= 1 reads
    vals.scatter_(-1, torch.where(nz, rank, 0), d)
    return rank, torch.where(rank > 0, vals.gather(-1, rank), 0)


def substitute_distances(d_packed: torch.Tensor) -> torch.Tensor:
    """Resolve zeroed repeat distances: d_eff[i] = last nonzero d at or
    before i in its row (0 if none). (B, n) int32 in and out; applied per
    block, whose first distance is explicit (lmd_type.rs:153-160)."""
    return _last_nonzero(d_packed)[1].to(d_packed.dtype)


def lz_rebuild_batch(literals: torch.Tensor, rows: torch.Tensor,
                     n_raw: torch.Tensor, n_out: int):
    """Rebuild container outputs from padded row streams.

    literals: (B, L) uint8 pools; rows: (B, R, 3) int32 (literal_len,
    match_len, d_effective), padding rows (0, 0, 0); n_raw: (B,) true output
    sizes; n_out: padded output size (>= max(n_raw)). Returns (out (B, n_out)
    uint8, ok (B,) bool), ``ok`` holding the reference's validity conditions
    (distance bounds, literal count, output size)."""
    B, R, _ = rows.shape
    L = literals.shape[1]
    dev = rows.device
    l, m, d_eff = (rows[:, :, k].long() for k in range(3))
    lit_end = torch.cumsum(l, dim=1)
    span_end = torch.cumsum(l + m, dim=1)
    span_start = span_end - (l + m)
    match_start = span_end - m

    total = span_end[:, -1]
    d_ok = torch.where(m > 0, (d_eff > 0) & (d_eff <= match_start),
                       True).all(dim=1)
    lit_ok = lit_end[:, -1] <= L
    ok = d_ok & lit_ok & (total == n_raw.long())

    out_pos = torch.arange(n_out, device=dev)
    pos = out_pos.expand(B, n_out)
    # owning row of each output position: first row with span_end > pos
    row = torch.searchsorted(span_end.contiguous(), pos.contiguous(),
                             right=True).clamp(max=R - 1)

    def take(x):
        return x.gather(1, row)

    r_span_start, r_match_start = take(span_start), take(match_start)
    r_lit_end, r_l, r_d = take(lit_end), take(l), take(d_eff)
    is_lit = pos < r_match_start
    lit_idx = (r_lit_end - r_l + (pos - r_span_start)).clamp(0, L - 1)
    parent = torch.where(is_lit, pos, pos - r_d.clamp(min=1))
    parent = parent.clamp(0, n_out - 1)

    root = parent
    for _ in range(max(int(n_out - 1).bit_length(), 1)):
        root = root.gather(1, root)
    out = literals.gather(1, lit_idx.gather(1, root))
    out = torch.where(pos < n_raw.long()[:, None], out, 0)
    return out.to(torch.uint8), ok


# --- the flat form: the kernel's plain version --------------------------------

def _segments(off: torch.Tensor) -> torch.Tensor:
    o = off.long()
    return o[1:] - o[:-1]


def row_prefix(rows: torch.Tensor, row_off: torch.Tensor,
               out_off: torch.Tensor):
    """(span_end, lit_end, row_start), int32 (R,): each container's
    inclusive prefix sums of l + m and of l over its own rows, computed
    exactly and clamped to int32's range (exact whenever a container's sums
    stay below 2**31, as they do for any container that can be valid), and
    each row's first output position in the flat output: its container's
    segment start plus the exclusive prefix sum of max(l + m, 0), capped at
    the segment's length. ``row_start`` is non-decreasing over the whole
    batch (for non-decreasing ``out_off``), and a position's row is its
    container's last row starting at or before it. Glue shared by the
    kernel and its plain version; no host sync."""
    R = rows.shape[0]
    dev = rows.device
    if R == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z, z
    l = rows[:, 0].long()
    lm = l + rows[:, 1].long()
    B = row_off.numel() - 1
    owner = torch.repeat_interleave(torch.arange(B, device=dev),
                                    _segments(row_off), output_size=R)
    first = row_off.long()[:-1][owner]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)

    def restarted(v):
        # 1-D scans: torch's scan along dim 0 of an (R, 3) tensor took
        # 2.4 s on the H100 for 12 M rows
        cs = torch.cumsum(v, 0)
        return cs - torch.cat((zero, cs))[first]

    ext = lm.clamp(min=0)
    start = out_off.long()[owner] + torch.minimum(
        restarted(ext) - ext, _segments(out_off)[owner])
    return (restarted(lm).clamp(_I32_MIN, _I32_MAX).int(),
            restarted(l).clamp(_I32_MIN, _I32_MAX).int(), start.int())


def lz_rebuild_flat(literals, lit_off, rows, row_off, n_raw, out_off,
                    n_out: int | None = None, detail: dict | None = None):
    """``lz_rebuild_batch`` per container on a flat, ragged layout.

    Container c's literal pool is ``literals[lit_off[c]:lit_off[c+1]]``
    (uint8), its rows ``rows[row_off[c]:row_off[c+1]]`` ((R, 3) int32, l and
    m >= 0, d substituted), its true size ``n_raw[c]`` and its output
    segment ``out[out_off[c]:out_off[c+1]]``; offsets are int32 (B + 1,)
    starting at 0 and non-decreasing. ``n_out`` is ``out_off[-1]`` when the
    caller knows it. Returns (out (n_out,) uint8, ok (B,) bool). Per
    container this is ``lz_rebuild_batch`` with L, R and n_out its own:
    positions past n_raw are 0, a position past the rows resolves through
    its last row, and an empty pool gives zeros. ``from_jax_rebuild_args``
    (``ops/cuda_rebuild``) lays the padded arguments out so that the two
    agree byte for byte. It resolves every match byte by plain pointer
    doubling over the whole map, one link a byte; with ``detail``, it sets
    ``detail["unresolved"]`` to the positions that still point at a parent
    before the first round and after each."""
    dev = rows.device
    B = n_raw.numel()
    if n_out is None:
        n_out = int(out_off[-1]) if B else 0
    R = rows.shape[0]
    span_end, lit_end, row_start = row_prefix(rows, row_off, out_off)
    Rc, Lc, Sc = _segments(row_off), _segments(lit_off), _segments(out_off)
    ro, lo_, oo = row_off.long(), lit_off.long(), out_off.long()
    l, m, d = (rows[:, k].long() for k in range(3))
    se, le = span_end.long(), lit_end.long()

    # ok: per container, then every match row's distance
    has = Rc > 0
    last = (ro[1:] - 1).clamp(min=0)
    total = torch.where(has, se[last] if R else 0, 0)
    lit_total = torch.where(has, le[last] if R else 0, 0)
    ok = (lit_total <= Lc) & (total == n_raw.long())
    if R:
        owner = torch.repeat_interleave(torch.arange(B, device=dev), Rc,
                                        output_size=R)
        bad = (m > 0) & ((d <= 0) | (d > _wrap32(se - m)))
        n_bad = torch.zeros(B, dtype=torch.int64, device=dev)
        n_bad.index_add_(0, owner, bad.long())
        ok &= n_bad == 0
    if n_out == 0:
        if detail is not None:
            detail["unresolved"] = []
        return torch.zeros(0, dtype=torch.uint8, device=dev), ok

    c = torch.repeat_interleave(torch.arange(B, device=dev), Sc,
                                output_size=n_out)
    i = torch.arange(n_out, device=dev)
    p = i - oo[c]
    # the owning row: the last row starting at or before the position, if
    # it is one of the container's own
    g = torch.searchsorted(row_start, i.int(), right=True).long() - 1
    row_ok = (g >= ro[c]) & (g < ro[c + 1])
    g = g.clamp(0, max(R - 1, 0))

    def at(x):
        return torch.where(row_ok, x[g], 0) if R else torch.zeros_like(p)

    rl, rm, rd, rse, rle = at(l), at(m), at(d), at(se), at(le)
    is_lit = p < _wrap32(rse - rm)
    li = _wrap32(rle - rl + (p - (rse - rl - rm)))
    L = Lc[c]
    li = torch.maximum(torch.minimum(li, L - 1), torch.zeros_like(li))
    parent = torch.minimum((p - rd.clamp(min=1)).clamp(min=0), Sc[c] - 1)
    # a root holds -(its literal index + 1); any other position its parent
    a = torch.where(is_lit | (parent == p), -(li + 1), oo[c] + parent)
    rounds = int(Sc.max() - 1).bit_length()
    counts = []
    for k in range(rounds + 1):
        if detail is not None:
            counts.append(torch.count_nonzero(a >= 0))
        if k < rounds:
            a = torch.where(a >= 0, a[a.clamp(min=0)], a)
    if detail is not None:
        counts = torch.stack(counts).tolist()
        while len(counts) > 1 and counts[-1] == counts[-2] == 0:
            counts.pop()
        detail["unresolved"] = counts
    src = (lo_[c] - a - 1).clamp(0, max(literals.numel() - 1, 0))
    val = literals[src].long() if literals.numel() else torch.zeros_like(p)
    out = torch.where((L > 0) & (p < n_raw.long()[c]), val, 0)
    return out.to(torch.uint8), ok


# --- the decoder's device flatten ---------------------------------------------

@dataclass
class Plan:
    """Where each piece of each container's row stream and literal pool
    comes from, in container order (host numpy arrays).

    A piece is an FSE block (kind 0: rows from the dense decoded ``lm``/``d``,
    literals from the decoded literal bytes, of which the rows consume a
    count known only on the device, at most ``lit_cap``) or a host part
    (kind 1: LZVN rows and literals, or a RAW block's one row and body).
    ``row_src``/``lit_src`` index the device sources with the host rows and
    literals appended after the dense ones."""
    kind: np.ndarray          # (K,) 0 = FSE block, 1 = host rows
    block: np.ndarray         # (K,) FSE block index, -1 for host rows
    row_src: np.ndarray       # (K,) first source row
    row_n: np.ndarray         # (K,) rows
    lit_src: np.ndarray       # (K,) first source literal byte
    lit_cap: np.ndarray       # (K,) literals (kind 1) or at most (kind 0)
    cont_piece_off: np.ndarray  # (n + 1,) pieces per container
    row_off: np.ndarray       # (n + 1,) rows per container
    host_rows: np.ndarray     # (H, 3) int32
    host_lits: np.ndarray     # (M,) uint8


def plan_pieces(conts, block_rows: tuple, block_lits: tuple,
                n_dense_rows: int, n_dense_lits: int) -> Plan:
    """The flatten plan of ``conts``: per container, its parts in stream
    order, each ``("fse", g)`` or ``("rows", rows (n, 3) int32, literals)``.
    FSE block g's rows lie at ``block_rows[0][g]`` (``block_rows[1][g]`` of
    them) and its literals at byte ``block_lits[0][g]`` (at most
    ``block_lits[1][g]``) of the dense sources."""
    kind, block, row_src, row_n, lit_src, lit_cap = ([] for _ in range(6))
    cpo, ro = [0], [0]
    h_rows, h_lits = [], []
    h_r = h_l = 0
    for parts in conts:
        ro.append(ro[-1])
        for part in parts:
            if part[0] == "fse":
                g = part[1]
                kind.append(0)
                block.append(g)
                row_src.append(int(block_rows[0][g]))
                row_n.append(int(block_rows[1][g]))
                lit_src.append(int(block_lits[0][g]))
                lit_cap.append(int(block_lits[1][g]))
            else:
                rows = np.asarray(part[1], np.int32).reshape(-1, 3)
                lits = part[2]
                if not isinstance(lits, np.ndarray):
                    lits = np.frombuffer(lits, np.uint8)
                kind.append(1)
                block.append(-1)
                row_src.append(n_dense_rows + h_r)
                row_n.append(len(rows))
                lit_src.append(n_dense_lits + h_l)
                lit_cap.append(len(lits))
                h_rows.append(rows)
                h_lits.append(lits)
                h_r += len(rows)
                h_l += len(lits)
            ro[-1] += row_n[-1]
        cpo.append(len(kind))

    def arr(x):
        return np.asarray(x, np.int64)

    return Plan(arr(kind), arr(block), arr(row_src), arr(row_n),
                arr(lit_src), arr(lit_cap), arr(cpo), arr(ro),
                np.concatenate(h_rows) if h_rows
                else np.zeros((0, 3), np.int32),
                np.concatenate(h_lits) if h_lits else np.zeros(0, np.uint8))


def flatten_pieces(lm: torch.Tensor, d: torch.Tensor,
                   lit_bytes: torch.Tensor, plan: Plan) -> dict:
    """Each container's flat row stream and literal pool, built on the
    device of ``lm``, with no host sync.

    ``lm`` (N,) int32 ``l | m << 16`` and ``d`` (N,) int32 raw distances
    are the decode kernel's dense L/M/D rows, ``lit_bytes`` (M,) uint8 its
    literals. An FSE piece's zero distances take the last nonzero one of
    the same piece (``substitute_distances`` per block; host rows are
    already effective). An FSE piece's pool holds only the literals its
    rows consume (at most ``lit_cap``), so the next piece's literal indices
    do not drift. Returns the ``lz_rebuild_flat`` arguments ``literals``,
    ``lit_off``, ``rows``, ``row_off`` (device) and ``consumed`` (K,) int64:
    the literals each piece's rows consume."""
    dev = lm.device
    K = len(plan.kind)
    R = int(plan.row_off[-1])
    cap = int(plan.lit_cap.sum())
    # every host array goes up first: a pageable copy waits for the stream
    tables = torch.from_numpy(np.stack(
        (plan.kind, plan.row_src, plan.row_n, plan.lit_src,
         plan.lit_cap))).to(dev)
    kind, row_src, row_n, lit_src, lit_cap = tables
    cpo = torch.from_numpy(plan.cont_piece_off).to(dev)
    row_off = torch.from_numpy(plan.row_off.astype(np.int32)).to(dev)
    hr = torch.from_numpy(np.ascontiguousarray(plan.host_rows, np.int32)).to(
        dev)
    h_lits = torch.from_numpy(plan.host_lits).to(dev)

    src_l = torch.cat((lm & 0xFFFF, hr[:, 0]))
    src_m = torch.cat(((lm >> 16) & 0xFFFF, hr[:, 1]))
    src_d = torch.cat((d, hr[:, 2]))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    flat_start = torch.cumsum(row_n, 0) - row_n
    piece = torch.repeat_interleave(torch.arange(K, device=dev), row_n,
                                    output_size=R)
    j = torch.arange(R, device=dev)
    idx = row_src[piece] + j - flat_start[piece]
    l, m, draw = src_l[idx], src_m[idx], src_d[idx]
    # an FSE piece's zero d takes the last nonzero d of the same piece:
    # the last nonzero before j lies in j's piece when its rank passes the
    # count of nonzeros before the piece
    rank, last_d = _last_nonzero(draw)
    before = torch.cat((zero, rank))[flat_start]
    sub = torch.where(rank > before[piece], last_d, 0)
    rows = torch.stack((l, m, torch.where(kind[piece] == 0, sub, draw)),
                       dim=1).int()

    csum = torch.cat((zero, torch.cumsum(l.long(), 0)))
    consumed = csum[flat_start + row_n] - csum[flat_start]
    lit_len = torch.where(kind == 0, torch.minimum(consumed, lit_cap),
                          lit_cap)
    pool_end = torch.cumsum(lit_len, 0)
    pool_start = pool_end - lit_len
    src = torch.cat((lit_bytes, h_lits))
    q = torch.arange(cap, device=dev)
    pc = torch.searchsorted(pool_end, q, right=True)
    pcs = pc.clamp(max=max(K - 1, 0))
    if K:
        at = (lit_src[pcs] + q - pool_start[pcs]).clamp(
            0, max(src.numel() - 1, 0))
        literals = torch.where(pc < K, src[at], 0).to(torch.uint8)
    else:
        literals = torch.zeros(0, dtype=torch.uint8, device=dev)
    lit_off = torch.cat((zero, pool_end))[cpo]
    return dict(literals=literals, lit_off=lit_off.int(), rows=rows,
                row_off=row_off, consumed=consumed)
