"""Grouped match finding: the CUDA kernel, its plain version, and the gather
of the saturated slots' candidate columns; and the sorted match finder.

Counterpart of ``lzfse_rust_tpu/ops/match_find_tpu.py``'s sort-free path
(``find_matches_grouped_compact`` and ``take_sat_cols``). The host has
already grouped each window's positions by hash bucket
(``native.match_group``): ``orders[b]`` lists window b's positions in
grouped order, and bit r-1 of ``oks[b, s]`` is set when the position r
slots back, ``orders[b, s - r]``, is a valid candidate of ``orders[b, s]``.
For every slot ``s`` of every window ``b``, with ``p = orders[b, s]``:

* candidate r (1..4) is ``c = orders[b, s - r]`` (the slot axis wraps, as
  ``jnp.roll`` does) where its bit is set, else ``-1``;
* its LCP is the index of the first byte where the 64-byte windows at p and
  at c differ (64 if none; the byte axis wraps at N, as the reference's
  rolled windows do), clipped as ``jnp.clip(lcp, 0, n_real - p)``, and 0
  where the bit is clear;
* arbitration in r order, strict ``>``: a match length is the LCP when it
  is at least 4 (or 3 with ``vn``), else 0; a candidate saturates when its
  LCP is 64 or reaches ``n_real``;
* a payload slot (``lo <= p < hi``) keys 0 when saturated, 1 when matched,
  2 otherwise; every other slot keys 2.

Inputs, all contiguous on one device: ``pads`` (B, N) uint8, ``n_reals``,
``los``, ``his`` (B,) int32, ``orders`` (B, N) int32 (positions in
[0, N)), ``oks`` (B, N) uint8.

``grouped_compact_ref`` returns every slot's outputs, as the JAX function
does: ``keys`` (B, N) uint8, ``best_cand`` and ``best_len`` (B, N) int32 (0
where nothing matched), ``cands`` and ``lcps`` (B, 4, N) int32.
``match_rows`` returns only what the encoder reads, window after window,
each window's slots in ascending order:

* ``offsets`` (B + 1, 2) int32: the matched and saturated rows before each
  window (row B: the totals M and S);
* ``matched`` (M, 2) int32, the key-1 slots' (slot, best_cand), and
  ``m_len`` (M,) uint8 their best_len (at most 64);
* ``sat`` (S, 9) int32, the key-0 slots' (slot, their 4 cands, their 4
  lcps).

On a CUDA device ``match_rows`` launches the kernel (``csrc/match_find.cu``)
or raises; only for CPU tensors does it run its plain version,
``match_rows_ref``: ``grouped_compact_ref``, then ``take_sat_cols`` on the
saturated slots, then the compaction as torch ops. ``launches`` counts
kernel launches; ``match_rows_launch`` and ``match_rows_finish`` split it
into the launch and the read of the totals, so that several devices can be
started first.

The sorted match finder (``find_matches_device``, ``find_matches_compact``:
the JAX package's argsort path) groups each window by a stable sort on the
device instead, as torch ops; it serves ``parallel/mesh.sharded_match_find``.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import torch

from ..base import constants as C
from ..runtime import cuda_lib
from .cuda_decode import _pointers, source_constant

WINDOW = 64  # bytes compared per LCP; longer runs are re-extended on the host
SAT_COLS = 1 + 2 * C.HASH_WIDTH  # slot, cands, lcps
SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "match_find.cu"
# slots per CUDA block of the kernel, as the source sets it: the scratch
# holds one status word per block
BLOCK_SLOTS = source_constant(SOURCE, re.compile(
    r"^constexpr int kBlockSlots = (\d+);", re.M), "kBlockSlots")

# kernel launches, for checks that a run went through the kernel
launches = {"match_grouped": 0}

_INPUTS = (("pads", torch.uint8, 2), ("n_reals", torch.int32, 1),
           ("los", torch.int32, 1), ("his", torch.int32, 1),
           ("orders", torch.int32, 2), ("oks", torch.uint8, 2))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _validate(tensors: dict) -> tuple[torch.device, int, int]:
    """Every input of its dtype, contiguous, on the device of ``pads``:
    (B, N) rows and (B,) vectors. Returns (device, B, N)."""
    pads = tensors["pads"]
    if pads.dim() != 2:
        raise ValueError(f"match_rows: pads must be (B, N), got "
                         f"{tuple(pads.shape)}")
    B, N = pads.shape
    for key, dtype, dims in _INPUTS:
        t = tensors[key]
        want = (B, N) if dims == 2 else (B,)
        if t.dtype != dtype:
            raise TypeError(f"match_rows: {key} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"match_rows: {key} must be contiguous")
        if t.device != pads.device:
            raise ValueError(f"match_rows: {key} is on {t.device}, pads "
                             f"on {pads.device}")
        if tuple(t.shape) != want:
            raise ValueError(f"match_rows: {key} must be {want}, got "
                             f"{tuple(t.shape)}")
    if B * N >= 2**31:
        raise ValueError(f"match_rows: {B} x {N} slots reach 2**31, beyond "
                         f"int32 row counts")
    return pads.device, B, N


def match_rows(pads, n_reals, los, his, orders, oks, vn: bool):
    """Grouped candidate LCPs, FIFO strict-max arbitration and the
    compaction of the matched and saturated slots for a batch of windows.
    Returns ``(offsets, matched, m_len, sat)`` (see the module docstring);
    on a card it reads the totals back (one sync) to size them."""
    return match_rows_finish(match_rows_launch(pads, n_reals, los, his,
                                               orders, oks, vn))


def match_rows_launch(pads, n_reals, los, his, orders, oks, vn: bool):
    """The enqueue half of ``match_rows``: on a card it launches the kernel
    and returns its outputs at full capacity, unread, so that several
    devices can be started before any total is read; on the CPU it returns
    the plain version's finished result. ``match_rows_finish`` takes
    either."""
    dev, B, N = _validate(dict(pads=pads, n_reals=n_reals, los=los, his=his,
                               orders=orders, oks=oks))
    if dev.type == "cpu":
        return match_rows_ref(pads, n_reals, los, his, orders, oks, vn)
    if dev.type != "cuda":
        raise ValueError(f"match_rows: no kernel for device {dev}")
    # the kernel reads each row as aligned 8-byte words
    if N % 8 or pads.data_ptr() % 8:
        raise ValueError(f"match_rows: the kernel needs N a multiple of 8 "
                         f"and 8-byte aligned pads, got N={N}")
    cap = B * N
    offsets = torch.zeros((B + 1, 2), dtype=torch.int32, device=dev)
    matched = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    m_len = torch.empty(cap, dtype=torch.uint8, device=dev)
    sat = torch.empty((cap, SAT_COLS), dtype=torch.int32, device=dev)
    if cap:
        # word 0: the block ticket; then one status word per CUDA block
        scratch = torch.zeros(1 + B * -(-N // BLOCK_SLOTS), dtype=torch.int64,
                              device=dev)
        with torch.cuda.device(dev):
            rc = cuda_lib.lib().lzt_match_rows(
                *_pointers(pads, n_reals, los, his, orders, oks),
                scratch.data_ptr(), scratch.data_ptr() + 8,
                *_pointers(matched, m_len, sat, offsets),
                B, N, int(bool(vn)), torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(rc, "match_grouped")
        launches["match_grouped"] += 1
    return offsets, matched, m_len, sat


def match_rows_finish(launched):
    """``match_rows_launch``'s outputs cut to their totals (a read of the
    totals, one sync on a card)."""
    offsets, matched, m_len, sat = launched
    M, S = offsets[-1].tolist()
    return offsets, matched[:M], m_len[:M], sat[:S]


def kernel_attrs() -> dict:
    """Registers, local (spill) bytes per thread and resident CUDA blocks
    per SM of the kernel, as the loaded library reports them (needs a
    card)."""
    a = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.lib().lzt_match_rows_attrs(a), "match_attrs")
    return {"registers": a[0], "local_bytes": a[1], "blocks_per_sm": a[2]}


def take_sat_cols(cands, lcps, idx):
    """The candidate and LCP columns (B, 4, S) of the slots ``idx`` (B, S)
    (int32, zero-padded): a gather along the slot axis."""
    at = idx.long()[:, None, :].expand(-1, cands.shape[1], -1)
    return cands.gather(2, at), lcps.gather(2, at)


# --- plain version --------------------------------------------------------------

def _windows_fwd(src_pad):
    """(N,) uint8 -> (N, WINDOW) forward byte windows, wrapping at N:
    row i is ``roll(src_pad, -i)[:WINDOW]``."""
    n = src_pad.shape[0]
    ext = torch.cat([src_pad, src_pad.repeat(-(-WINDOW // n))[:WINDOW - 1]])
    return ext.unfold(0, WINDOW, 1)


def _first_mismatch(a, b):
    """Index of the first differing byte of each row pair, WINDOW if none."""
    neq = a != b
    first = neq.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(neq.any(dim=1), first, WINDOW)


def _grouped_core(src_pad, n_real, order, ok):
    """Window b's candidates (HASH_WIDTH, N) and clipped first-window LCPs,
    in grouped-slot order: candidate r of slot s is slot s - r."""
    pos = order
    cap = n_real - pos
    a = _windows_fwd(src_pad)[pos.long()]
    cands, lcps = [], []
    for r in range(1, C.HASH_WIDTH + 1):
        okr = ((ok.to(torch.int32) >> (r - 1)) & 1) != 0
        b = torch.roll(a, r, dims=0)
        lcp = torch.minimum(torch.clamp(_first_mismatch(a, b), min=0), cap)
        lcps.append(torch.where(okr, lcp, 0))
        cands.append(torch.where(okr, torch.roll(order, r), -1))
    return pos, torch.stack(cands), torch.stack(lcps)


def _arbitrate(pos, cands, lcps, n_real, lo, hi, vn: bool):
    """FIFO strict-max arbitration of one window's candidates: (saturated,
    matched, best_cand, best_len) per slot; only payload slots (``lo <= p
    < hi``) are saturated or matched."""
    best_len = torch.zeros_like(pos)
    best_cand = torch.zeros_like(pos)
    sat = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    for cand, lcp in zip(cands, lcps):
        okc = cand >= 0
        short = torch.where(lcp == 3, lcp, 0) if vn else torch.zeros_like(lcp)
        mlen = torch.where(okc, torch.where(lcp >= 4, lcp, short), 0)
        sat = sat | (okc & ((lcp == WINDOW) | (pos + lcp >= n_real)))
        take = mlen > best_len
        best_len = torch.where(take, mlen, best_len)
        best_cand = torch.where(take, cand, best_cand)
    payload = (pos >= lo) & (pos < hi)
    sat = payload & sat
    matched = payload & ((best_len > 0) | sat)
    return sat, matched, best_cand, best_len


def _grouped_compact_one(src_pad, n_real, lo, hi, order, ok, vn: bool):
    """One window: ``(key, best_cand, best_len, cands, lcps)``."""
    pos, cands, lcps = _grouped_core(src_pad, n_real, order, ok)
    sat, matched, best_cand, best_len = _arbitrate(pos, cands, lcps, n_real,
                                                   lo, hi, vn)
    key = torch.where(sat, 0, torch.where(matched, 1, 2)).to(torch.uint8)
    return key, best_cand, best_len, cands, lcps


def grouped_compact_ref(pads, n_reals, los, his, orders, oks, vn: bool):
    """Every slot's outputs, as the JAX ``find_matches_grouped_compact``
    returns them (see the module docstring), one window at a time."""
    B, N = pads.shape
    if B == 0 or N == 0:
        dev = pads.device
        z = torch.zeros((B, N), dtype=torch.int32, device=dev)
        zc = torch.zeros((B, C.HASH_WIDTH, N), dtype=torch.int32, device=dev)
        return z.to(torch.uint8), z, z.clone(), zc, zc.clone()
    outs = [_grouped_compact_one(pads[b], n_reals[b], los[b], his[b],
                                 orders[b], oks[b], vn) for b in range(B)]
    return tuple(torch.stack(col) for col in zip(*outs))


def match_rows_ref(pads, n_reals, los, his, orders, oks, vn: bool):
    """Plain PyTorch version of ``match_rows``: ``grouped_compact_ref``,
    then ``take_sat_cols`` on each window's saturated slots (zero-padded to
    the most any window has), then the rows compacted in window order."""
    keys, best_cand, best_len, cands, lcps = grouped_compact_ref(
        pads, n_reals, los, his, orders, oks, vn)
    B = keys.shape[0]
    dev = keys.device
    counts = torch.stack(((keys == 1).sum(1), (keys == 0).sum(1)), 1)
    offsets = torch.cat((torch.zeros((1, 2), dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0))).int()
    mw, ms = torch.nonzero(keys == 1, as_tuple=True)
    matched = torch.stack((ms, best_cand[mw, ms]), 1).int()
    m_len = best_len[mw, ms].to(torch.uint8)
    sw, ss = torch.nonzero(keys == 0, as_tuple=True)
    rank = torch.arange(len(ss), device=dev) - offsets[sw, 1].long()
    smax = int(counts[:, 1].max()) if B else 0
    idx = torch.zeros((B, smax), dtype=torch.int32, device=dev)
    idx[sw, rank] = ss.int()
    cs, ls = take_sat_cols(cands, lcps, idx)
    sat = torch.cat((ss[:, None].int(), cs[sw, :, rank], ls[sw, :, rank]), 1)
    return offsets, matched, m_len, sat


# --- the sorted match finder (the argsort path) ---------------------------------
#
# Counterpart of the JAX package's ``find_matches_device``, ``_compact_one``
# and ``find_matches_compact``: the grouping is a stable sort on the device,
# not ``native.match_group`` on the host. Torch ops on whatever device the
# window lies on; ``parallel/mesh.sharded_match_find`` runs them per shard.

def _buckets(src_pad, n_real, vn: bool):
    """Each position's Knuth hash bucket of its 4 bytes (3 with ``vn``),
    the bytes wrapping at N; positions past ``n_real - 4`` go to the
    reserved bucket ``1 << HASH_BITS``, which no probed position shares."""
    s = src_pad.long()
    vals = (s | (torch.roll(s, -1) << 8) | (torch.roll(s, -2) << 16)
            | (torch.roll(s, -3) << 24))
    hv = vals & 0x00FFFFFF if vn else vals
    # hv * HASH_MUL mod 2**32 in two halves: the full product overflows int64
    prod = ((hv & 0xFFFF) * C.HASH_MUL
            + ((((hv >> 16) * C.HASH_MUL) & 0xFFFF) << 16))
    bucket = (prod & 0xFFFFFFFF) >> (32 - C.HASH_BITS)
    probed = torch.arange(s.shape[0], device=s.device) <= n_real - 4
    return torch.where(probed, bucket, 1 << C.HASH_BITS).int()


def find_matches_device(src_pad, n_real, vn: bool):
    """Candidates and first-window LCPs of one zero-padded window
    ``src_pad`` (N,) uint8 of ``n_real`` bytes, in bucket-sorted order:
    ``(pos (N,), cands (HASH_WIDTH, N), lcps (HASH_WIDTH, N))``, int32.

    A stable sort by bucket groups the positions; candidate r of sorted slot
    s is slot s - r where it shares the bucket, lies no more than the
    largest distance back (``VN_MAX_D_VALUE`` with ``vn``) and before the
    position. Those tests give the ``ok`` bits of ``_grouped_core``, which
    then computes what the grouped path does."""
    bucket = _buckets(src_pad, n_real, vn)
    b_sorted, order = torch.sort(bucket, stable=True)
    order = order.int()
    max_d = C.VN_MAX_D_VALUE if vn else C.MAX_D_VALUE
    slot = torch.arange(order.shape[0], device=order.device)
    ok = torch.zeros_like(order)
    for r in range(1, C.HASH_WIDTH + 1):
        cand = torch.roll(order, r)
        okr = ((torch.roll(b_sorted, r) == b_sorted) & (slot >= r)
               & (order - cand <= max_d) & (cand < order))
        ok |= okr.int() << (r - 1)
    return _grouped_core(src_pad, n_real, order, ok)


def _compact_one(src_pad, n_real, lo, hi, vn: bool):
    """One window through ``find_matches_device`` and the arbitration, its
    slots reordered saturated first, then matched, then the rest (a stable
    sort by key): ``(counts (2,) [saturated, matched], pos, best_cand,
    best_len, cands, lcps)``."""
    pos, cands, lcps = find_matches_device(src_pad, n_real, vn)
    sat, matched, best_cand, best_len = _arbitrate(pos, cands, lcps, n_real,
                                                   lo, hi, vn)
    key = torch.where(sat, 0, torch.where(matched, 1, 2))
    order = torch.sort(key, stable=True).indices
    counts = torch.stack((sat.sum(), matched.sum())).int()
    return (counts, pos[order], best_cand[order], best_len[order],
            cands[:, order], lcps[:, order])


def find_matches_compact(src_pads, n_reals, los, his, vn: bool):
    """``_compact_one`` over a batch of windows (B, N), one window at a time
    (each holds an (N, 64) byte-window matrix): ``(counts (B, 2), pos,
    best_cand, best_len (B, N), cands, lcps (B, HASH_WIDTH, N))``."""
    B, N = src_pads.shape
    if B == 0:
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=src_pads.device)
        return (z(0, 2), z(0, N), z(0, N), z(0, N), z(0, C.HASH_WIDTH, N),
                z(0, C.HASH_WIDTH, N))
    outs = [_compact_one(src_pads[b], n_reals[b], los[b], his[b], vn)
            for b in range(B)]
    return tuple(torch.stack(col) for col in zip(*outs))
