"""TorchEncoder -- batched LZFSE container encode whose tANS block emission
runs on a CUDA device.

Counterpart of ``lzfse_rust_tpu.models.encoder.TpuEncoder`` with
``frontend="native"`` and device emission, its serving default. The host
layers are the port's own copies of the JAX package's: the native frontend,
staging and packing (``runtime/native.py``), the block parse
(``_parse_blocks``), and the spec layer's block headers and weight
payloads. What runs on the device is the
E-table build (``ops/fse_encode.py``) and the two encode kernels of
``ops/cuda_encode.py``.

``encode_many``, the serving path (``TpuEncoder._encode_many_staged``):

1. small: inputs of at most ``VN_CUTOFF`` bytes go to ``native.encode_bytes``
   (LZVN or RAW blocks);
2. frontend: ``native.frontend_stage`` per source, over a host thread pool
   (it releases the GIL), finds matches, selects and splits blocks, and
   writes every closed block -- and its period-split alternative -- into
   one staging pool, pinned on a card. A pool too small for the batch is
   the one failure that is retried: the pool doubles and the frontends run
   again;
3. emit_prep: each kernel's slots are ordered longest first, and the
   staged rows go up in ``non_blocking`` copies;
4. emit_dispatch: the E tables and the literal and L/M/D kernels are
   enqueued, with the pinned downloads of the push groups and final
   states; emit_kernels: the wait for them;
5. pack: ``native.pack_stage`` packs every slot's groups into its block
   body; a block's period-split alternative wins when it is strictly
   smaller (ties keep the block as it is), as ``emit_best`` decides.

``LZT_ENC_CHUNKS`` (read per call, default 1, clamped to [1, number of
sources above ``VN_CUTOFF``]) pipelines steps 2-4 as the JAX encoder does:
the biggest sources are dealt round-robin into that many chunks; each
chunk's frontends stage into the next contiguous slots of the one pool,
and its steps 3-4 are enqueued on the device, into the same rows of one
host buffer, while the host runs the next chunk's frontends; after the
last chunk one wait and step 5 over every slot. One chunk is the same
path with nothing to overlap. Each encode kernel launches once a chunk;
the containers do not change.

``encode_bytes`` ports the native-frontend branch of
``TpuEncoder.encode_bytes``: ``native.frontend_blocks``, the period-split
choice, per-block staging with ``native.block_weights``, the same two
kernels, ``native.pack_groups`` (with the V2 weight payload that
``native.block_weights`` writes), and header assembly from ``spec.fse``.

``frontend="device"`` ports ``TpuEncoder``'s device frontend (its
sort-free grouped path): matches are found on the device, then selected
and emitted as above. ``encode_many`` runs, per stage:

1. small: as above;
2. win_prep: every large source is cut into overlapping windows of at most
   ``WINDOW_N`` bytes (``_window_geometry``: each window after the first
   carries ``WINDOW_CTX`` bytes of history, so its candidates are exact);
   the windows are grouped by padded size N, and ``native.match_group``
   groups each window's positions by hash bucket on a host thread pool,
   into pinned buffers;
3. matchfind: per N, one upload of the windows, one launch of the grouped
   match kernel (``ops/match_find.match_rows``), which compacts the
   matched slots' winners and the saturated slots' candidate columns on
   the device, and one download of those rows (with a ``mesh``, the
   windows, padded with inert ones to a multiple of the mesh size, split
   into a shard a device: ``parallel/mesh.sharded_grouped_match``);
4. arbitrate: saturated slots are re-extended exactly on the host
   (``_arbitrate_window``); matched slots come from the download;
5. merge: per source, the windows' rows are joined, extended backwards
   (``spec.match_find._lcp_backward``) and sorted by position;
6. select: ``native.select_blocks`` per source;
7. emit_prep, emit_dispatch, emit_kernels, pack: every block of every
   source staged and emitted in one pass of the two encode kernels, as
   ``encode_bytes`` does.

``LZT_DEV_GROUPED`` set to anything but ``"1"`` (the default) takes the
JAX encoder's argsort branch for step 3 instead (``_windows_compact``:
``ops/match_find.find_matches_compact``, torch ops on the device, one
window size at a time, and no mesh); the other steps are the same. It is
kept for parity with the JAX encoder and as a reference for the grouped
kernel, not as a faster choice.

``device_emission=False`` ports ``TpuEncoder(device_emission=False)``:
matches are found in the device windows (steps 1-5 above, whatever
``frontend`` says, as the JAX encoder takes its native frontend only with
device emission), then ``native.select_emit_fse`` selects and emits each
source's blocks on the host, one call a source on a host thread pool
(step 6, ``select_emit``, in place of steps 6-7). Nothing is emitted on
the device.

Every output is byte-identical to ``native.encode_bytes``. Unlike the JAX
encoder, nothing falls back to a host encoder: an error in a kernel, a
transfer or a native call raises. ``device="cpu"`` runs the kernels' plain
versions; it exists for the tests. A CUDA device without a card raises.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os

import numpy as np
import torch

from ..base import constants as C
from ..base.errors import LzfseError
from ..ops import cuda_encode as K
from ..ops import match_find as MF
from ..ops.fse_encode import build_encode_tables
from ..parallel.mesh import sharded_grouped_match
from ..runtime.build import native_runtime
from ..spec import fse as F
from ..spec.match_find import MatchStream, _lcp_backward, _lcp_forward
from ..utils.buffers import _round_up, host_buffer
from ..utils.timing import _Clock

# staged row width: LMDS_PER_BLOCK rounded up to 128, the width
# native.frontend_stage and native.pack_stage are used with
N_COLS = -(-C.LMDS_PER_BLOCK // 128) * 128
WPAY_CAP = 640   # bytes per slot for a V2 weight payload (at most 630)
MAX_SLOTS = 1 << 20
EOS = C.MAGIC_EOS.to_bytes(4, "little")
FRONTENDS = ("native", "device")

# Match-window geometry of the device frontend (TpuEncoder's). The padded
# size N of a window is a power of two; a window leaves 128 bytes of pad
# headroom. Each window after the first carries WINDOW_CTX bytes of history,
# which covers the format's largest match distance (262139) and the probe
# width, so the candidates of its payload positions are exact; each carries
# 3 bytes past its payload so every payload position has its 4-byte probe.
WINDOW_N = 1 << 20
WINDOW_CAP = WINDOW_N - 128
WINDOW_CTX = 1 << 18
WINDOW_STRIDE = WINDOW_CAP - WINDOW_CTX - 3

# staging pool: name, per-slot shape, dtype. The first nine are the arrays
# of native.frontend_stage, in its order; the slot orders ride along
_POOL = (("weights", (C.N_WEIGHTS,), torch.int64),
         ("litw", (N_COLS * 4,), torch.uint8),
         ("lit_num", (), torch.int32),
         ("lmv", (N_COLS,), torch.int32),
         ("dv", (N_COLS,), torch.int32),
         ("lmd_num", (), torch.int32),
         ("meta", (4,), torch.int32),
         ("wpay", (WPAY_CAP,), torch.uint8),
         ("wpay_len", (), torch.int32),
         ("order_l", (), torch.int32),
         ("order_m", (), torch.int32))
_UPLOAD = ("weights", "litw", "lit_num", "lmv", "dv", "lmd_num", "order_l",
           "order_m")
# widths of the emission's outputs, as the kernels return them: glo, gmeta,
# literal states, mlo, mmeta, L/M/D states
_DOWN_WIDTHS = (N_COLS, N_COLS, 4, N_COLS, N_COLS, 3)


def _parse_blocks(blob: bytes):
    """Raw block contents from a select_blocks/frontend_blocks blob:
    [(lits u8[], rows3 int32[n,3], n_match_bytes), ...].

    Copied from ``TpuEncoder._parse_blocks``
    (``lzfse_rust_tpu/models/encoder.py``)."""
    blocks = []
    rec = np.dtype([("l", "<u2"), ("m", "<u2"), ("d", "<u4")])
    off = 0
    n = len(blob)
    while off < n:
        n_lit, n_lmd, n_mb = np.frombuffer(blob, np.uint32, 3, off)
        off += 12
        lits = np.frombuffer(blob, np.uint8, int(n_lit), off)
        off += int(n_lit)
        raw = np.frombuffer(blob, rec, int(n_lmd), off)
        off += 8 * int(n_lmd)
        rows3 = np.stack([raw["l"], raw["m"], raw["d"]],
                         axis=1).astype(np.int32)
        blocks.append((lits, rows3, int(n_mb)))
    return blocks


def _map(fn, items) -> list:
    """``[fn(x) for x in items]`` over a host thread pool (the native calls
    release the GIL). The first exception propagates."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    with cf.ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


# --- device frontend: host halves, copied from TpuEncoder ---------------------

def _bucket_pow2(x: int, lo: int = 4096) -> int:
    x = max(x, lo)
    return 1 << (x - 1).bit_length()


def _window_geometry(n_full: int, start: int):
    """(base, ctx, n, N) for the window probing src[start : start+stride]
    with its history context."""
    ctx = min(start, WINDOW_CTX)
    base = start - ctx
    n = min(n_full, start + WINDOW_STRIDE + 3) - base
    N = min(_bucket_pow2(n + 128), WINDOW_N)
    assert n + 128 <= N
    return base, ctx, n, N


def _source_windows(i: int, n_full: int) -> list:
    """The windows ``(i, base, ctx, n, N)`` of source i, n_full bytes."""
    return [(i, *_window_geometry(n_full, start))
            for start in range(0, n_full, WINDOW_STRIDE)]


def _arbitrate_window(full: np.ndarray, base: int, ctx: int, n: int, pos,
                      cands, lcps, vn: bool):
    """Host half of one window: payload filtering, exact re-extension of
    window-saturated LCPs, FIFO strict-max arbitration. Returns the
    (abs_pos, best_cand, best_len) rows that matched."""
    n_full = len(full)
    pos = pos.astype(np.int64)
    cands = cands.astype(np.int64)
    lcps = lcps.astype(np.int64)

    # only payload-region probes count; context and overhang probes are
    # discarded (the overhang belongs to the next window's payload)
    payload = (pos >= ctx) & (pos < ctx + WINDOW_STRIDE)
    pos = pos[payload]
    cands = cands[:, payload]
    lcps = lcps[:, payload]
    abs_pos = pos + base

    best_len = np.zeros(len(pos), np.int64)
    best_cand = np.zeros(len(pos), np.int64)
    for r in range(cands.shape[0]):
        cand_r, lcp_r = cands[r], lcps[r]
        abs_cand = cand_r + base
        # an LCP is truncated if it hit the 64-byte compare window OR the
        # window end; both re-extend against the full buffer with the
        # block-end cap
        sat = np.flatnonzero(
            (cand_r >= 0) & (abs_pos + lcp_r < n_full)
            & ((lcp_r == MF.WINDOW) | (pos + lcp_r >= n)))
        if len(sat):
            lcp_r[sat] = _lcp_forward(
                full, abs_pos[sat], abs_cand[sat], lcp_r[sat],
                (n_full - abs_pos[sat]).astype(np.int64))
        if vn:
            mlen = np.where(lcp_r >= 4, lcp_r, np.where(lcp_r == 3, 3, 0))
        else:
            mlen = np.where(lcp_r >= 4, lcp_r, 0)
        mlen = np.where(cand_r >= 0, mlen, 0)
        take = mlen > best_len
        best_len[take] = mlen[take]
        best_cand[take] = abs_cand[take]

    keep = best_len > 0
    return abs_pos[keep], best_cand[keep], best_len[keep]


def _by_n(wins: list) -> list:
    """(N, indices of the windows of padded size N), N ascending."""
    by_n: dict = {}
    for k, w in enumerate(wins):
        by_n.setdefault(w[4], []).append(k)
    return sorted(by_n.items())


def _merge(full: np.ndarray, parts) -> MatchStream:
    """One source's windows' (abs_pos, cand, len) rows joined into a match
    stream: backward extension, then sorted by position (stable)."""
    pos_k = np.concatenate([p for p, _, _ in parts])
    cand_k = np.concatenate([c for _, c, _ in parts])
    fwd_k = np.concatenate([f for _, _, f in parts])
    back_k = _lcp_backward(full, pos_k, cand_k, np.minimum(cand_k, pos_k))
    order = np.argsort(pos_k, kind="stable")
    return MatchStream(pos=pos_k[order], match_pos=cand_k[order],
                       fwd_len=fwd_k[order], back_max=back_k[order])


def _stream_rows(stream: MatchStream) -> np.ndarray:
    """A match stream as the native selection takes it: (pos, match_pos,
    fwd_len, back_max) rows."""
    return np.stack([stream.pos, stream.match_pos, stream.fwd_len,
                     stream.back_max], axis=1)


def _slot_bound(sources, big) -> int:
    """The staging pool's first size for the sources ``big``: every closed
    block consumes >= 40000 source bytes (10000 rows of >= 4-byte matches,
    or the 40000-literal cap), +1 final block; the slack covers
    period-split alternatives. A pool too small doubles and the frontends
    run again."""
    return sum(len(sources[i]) // 40000 + 2 for i in big) + 32


class _Pool:
    """Host staging arrays for ``slots`` blocks: torch tensors (pinned for a
    card) and the numpy views the native calls fill."""

    def __init__(self, slots: int, pinned: bool):
        self.slots = slots
        self.t = {k: torch.empty((slots, *shape), dtype=dt, pin_memory=pinned)
                  for k, shape, dt in _POOL}
        self.a = {k: v.numpy() for k, v in self.t.items()}

    def native_bufs(self) -> tuple:
        return tuple(self.a[k] for k, _, _ in _POOL[:9])


# the default of ``frontend``: "native", or "device" with a mesh
_DEFAULT_FRONTEND = object()


class TorchEncoder:
    """Batched container encoder whose tANS emission runs in the CUDA
    kernels of ``ops/cuda_encode.py`` (or their plain versions on CPU).

    ``frontend`` picks the match finder: ``"native"`` (the default, the
    native history-table frontend per source) or ``"device"`` (windowed
    match finding in the kernel of ``ops/match_find.py``, on several
    devices with a ``mesh``). ``device_emission=False`` emits on the host
    instead (``native.select_emit_fse`` per source, after the device
    frontend's match finding)."""

    def __init__(self, device="cuda", frontend: str = _DEFAULT_FRONTEND,
                 mesh=None, device_emission: bool = True):
        """``mesh`` (``parallel/mesh.make_mesh``, devices of ``device``'s
        type): the device frontend's window batch of each window size,
        padded with inert windows to a multiple of the mesh size, splits
        into contiguous shards, each matched on its device
        (``parallel/mesh.sharded_grouped_match``); the emission stays on
        ``device``. A mesh implies ``frontend="device"``; without one the
        default frontend is ``"native"``.

        ``device_emission=False`` (``TpuEncoder(device_emission=False)``):
        the device windows find the matches and the host selects and emits
        the blocks. The default frontend is then ``"device"``, and
        ``frontend="native"`` is kept as given but not run, as the JAX
        encoder runs its native frontend only with device emission."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchEncoder: device 'cuda' requested "
                                   "but CUDA is not available")
        elif self.device.type != "cpu":
            raise ValueError(f"TorchEncoder: unsupported device {device!r}")
        if frontend is _DEFAULT_FRONTEND:
            frontend = ("native" if mesh is None and device_emission
                        else "device")
        if frontend not in FRONTENDS:
            raise ValueError(f"TorchEncoder: frontend must be one of "
                             f"{FRONTENDS}, got {frontend!r}")
        if mesh is not None:
            if frontend != "device" and device_emission:
                raise ValueError("TorchEncoder: a mesh shards the device "
                                 "frontend; frontend='native' has no "
                                 "device stage to shard")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"TorchEncoder: the mesh's devices "
                                 f"{mesh.devices} are not all of type "
                                 f"{self.device.type!r}")
        self.frontend = frontend
        self.mesh = mesh
        self.device_emission = bool(device_emission)
        # the JAX dispatch: the native frontend runs only with device
        # emission; every other combination finds matches in the windows
        self._windows_path = frontend == "device" or not device_emission
        self._native = native_runtime()
        self._pool: _Pool | None = None
        self._pool_free = None   # event: the last upload from _pool is done
        self._down: torch.Tensor | None = None   # host download, int32
        self._arena: np.ndarray | None = None    # packed block bodies
        self._bufs: dict = {}    # the device frontend's host buffers, bytes
        self.last_emission: str | None = None

    # -- staging ---------------------------------------------------------

    def _host(self, key: str, shape: tuple, dtype) -> torch.Tensor:
        """A host tensor of ``shape`` over the reusable byte buffer ``key``
        (pinned for a card), grown when too small."""
        n = math.prod(shape) * dtype.itemsize
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(_round_up(max(n, 1), 1 << 20), dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._bufs[key] = buf
        return buf[:n].view(dtype).view(shape)

    def _staging(self, slots: int) -> _Pool:
        # the previous call's upload may still read the pool: wait for it
        # before refilling
        if self._pool_free is not None:
            self._pool_free.synchronize()
            self._pool_free = None
        if self._pool is None or self._pool.slots < slots:
            self._pool = _Pool(_round_up(slots, 256), self.device.type == "cuda")
        return self._pool

    def _frontends(self, sources, big, clock: _Clock | None = None,
                   n_chunks: int = 1, emit: bool = False):
        """Run ``native.frontend_stage`` on every source in ``big``, in
        ``n_chunks`` chunks: the biggest sources dealt round-robin, as
        ``TpuEncoder._encode_many_staged`` deals them under
        ``LZT_ENC_CHUNKS``; each chunk stages into the next contiguous
        slots of one pool. With ``emit``, each chunk's emission is enqueued
        (``_emit_chunk``) before the next chunk's frontends run. A pool too
        small for the batch is the one failure that is retried: the chunks
        in flight are waited for, the pool doubles and every frontend runs
        again. Returns (pool, slots used, per-source base-slot lists,
        per-source block counts, the emitted chunks)."""
        clock = clock or _Clock(None)
        groups: list = [[] for _ in range(n_chunks)]
        for r, i in enumerate(sorted(big, key=lambda i: -len(sources[i]))):
            groups[r % n_chunks].append(i)
        bound = _slot_bound(sources, big)
        while True:
            pool = self._staging(bound)
            bufs = pool.native_bufs()
            counter = np.zeros(1, np.int64)
            out_lists = {i: np.zeros(len(sources[i]) // 40000 + 2, np.int32)
                         for i in big}
            nb_of: dict = {}
            chunks: list = []
            try:
                for grp in groups:
                    clock.begin("frontend")
                    s0 = int(counter[0])
                    nb_of.update(zip(grp, _map(
                        lambda i: self._native.frontend_stage(
                            sources[i], bufs, counter, out_lists[i]), grp)))
                    s1 = int(counter[0])
                    clock.mark("frontend")
                    # a period-split alternative is staged by its block's
                    # own frontend call, so it lies in the block's chunk
                    alt = pool.a["meta"][s0:s1, 2]
                    alt = alt[(alt >= 0) & ((alt < s0) | (alt >= s1))]
                    if len(alt):
                        raise RuntimeError(
                            f"frontend_stage staged a period-split "
                            f"alternative outside its chunk [{s0}, {s1}): "
                            f"{alt[:8]}")
                    if emit and s1 > s0:
                        chunks.append(self._emit_chunk(pool, s0, s1, clock))
            except LzfseError:
                # the pool overflowed: the chunks in flight still read it
                # and write the download buffer; wait for them, then run
                # every frontend again in a doubled pool
                for c in chunks:
                    if c["events"]:
                        c["events"][-1].synchronize()
                self._pool_free = None
                if bound > MAX_SLOTS:
                    raise
                bound *= 2
                continue
            break
        nb = int(counter[0])
        # an input above VN_CUTOFF always closes at least one block; assembly
        # reads each source's base slots
        if nb < 1 or min(nb_of.values()) < 1:
            raise RuntimeError(f"frontend_stage staged {nb} slots, block "
                               f"counts {[nb_of[i] for i in big]}: a source "
                               f"closed no block")
        return pool, nb, out_lists, nb_of, chunks

    def _upload(self, pool: _Pool, s0: int, s1: int) -> dict:
        """Order the slots [s0, s1) (the orders index those rows, from 0)
        and send those rows of the pool to the device. Returns the device
        tensors (views of the pool on CPU); on a card ``"upload"`` holds the
        copies' (start, end) events, and the pool is busy until the end
        (``_pool_free``)."""
        a = pool.a
        a["order_l"][s0:s1] = K.slot_order(
            K.steps_of("literals", a["lit_num"][s0:s1], N_COLS))
        a["order_m"][s0:s1] = K.slot_order(
            K.steps_of("lmds", a["lmd_num"][s0:s1], N_COLS))
        cuda = self.device.type == "cuda"
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        dev = {k: pool.t[k][s0:s1].to(self.device, non_blocking=True)
               for k in _UPLOAD}
        if cuda:
            ev[1].record()
            self._pool_free = ev[1]
            dev["upload"] = ev
        return dev

    @staticmethod
    def _kwargs(dev: dict) -> tuple[dict, dict]:
        """The E tables, then both kernels' keyword arguments."""
        e_l, e_m, e_d, e_u = build_encode_tables(dev["weights"])
        lit = dict(e_u=e_u, words=dev["litw"].view(torch.int32),
                   num=dev["lit_num"], order=dev["order_l"])
        lmd = dict(e_l=e_l, e_m=e_m, e_d=e_d, lm=dev["lmv"], d=dev["dv"],
                   num=dev["lmd_num"], order=dev["order_m"])
        return lit, lmd

    def _download_rows(self, slots: int) -> list:
        """Host tensors ``(slots, width)`` for the six emission outputs
        (glo, gmeta, literal states, mlo, mmeta, L/M/D states) over the
        reusable download buffer, pinned for a card."""
        self._down = host_buffer(self._down, slots * sum(_DOWN_WIDTHS),
                                 self.device.type == "cuda")
        rows, o = [], 0
        for w in _DOWN_WIDTHS:
            rows.append(self._down[o:o + slots * w].view(slots, w))
            o += slots * w
        return rows

    def _emit_chunk(self, pool: _Pool, s0: int, s1: int,
                    clock: _Clock) -> dict:
        """Enqueue the emission of the slots [s0, s1): upload of those rows
        (``emit_prep``), E tables, both kernels and the downloads into the
        same rows of the download buffer (``emit_dispatch``), all without
        waiting for the device. Returns the chunk's bytes up and down, the
        download rows and, on a card, its events (upload start, upload end,
        kernels end, downloads end)."""
        clock.begin("emit_prep")
        host = self._download_rows(pool.slots)
        dev = self._upload(pool, s0, s1)
        clock.mark("emit_prep")
        clock.begin("emit_dispatch")
        lit, lmd = self._kwargs(dev)
        outs = (*K.encode_literals(**lit), *K.encode_lmds(**lmd))
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        for h, x in zip(host, outs):
            h[s0:s1].copy_(x, non_blocking=cuda)
        if cuda:
            ev[1].record()
        clock.mark("emit_dispatch")
        return {"up": sum(dev[k].nbytes for k in _UPLOAD),
                "down": sum(x.nbytes for x in outs), "host": host,
                "events": (*dev["upload"], *ev) if cuda else ()}

    def _emit_wait(self, chunks: list, nb: int, stats: dict | None,
                   clock: _Clock) -> list:
        """Wait for the emitted chunks (``emit_kernels``). Adds their bytes
        and, on a card, the CUDA-event ms of their uploads, E tables and
        kernels, and downloads to ``stats``. Returns host arrays (glo,
        gmeta, literal states, mlo, mmeta, L/M/D states) of the slots
        [0, nb)."""
        clock.begin("emit_kernels")
        if chunks[-1]["events"]:
            chunks[-1]["events"][-1].synchronize()
        if stats is not None:
            for key, part in (("upload_bytes", "up"),
                              ("download_bytes", "down")):
                stats[key] = stats.get(key, 0) + sum(c[part] for c in chunks)
            if self.device.type == "cuda":
                det = stats.setdefault("detail_device", {})
                for key, a, b in (("upload_ms", 0, 1), ("kernels_ms", 1, 2),
                                  ("download_ms", 2, 3)):
                    det[key] = det.get(key, 0.0) + sum(
                        c["events"][a].elapsed_time(c["events"][b])
                        for c in chunks)
        clock.mark("emit_kernels")
        return [h.numpy()[:nb] for h in chunks[-1]["host"]]

    # -- public ----------------------------------------------------------

    def encode_many(self, sources: list[bytes],
                    stats: dict | None = None) -> list[bytes]:
        """Encode a batch of sources, every FSE block of all of them in one
        device emission pass. Byte-identical to ``encode_bytes`` and to
        ``native.encode_bytes`` per source.

        ``stats``, when given, receives wall-clock seconds per stage
        (``small``, ``frontend``, ``emit_prep``, ``emit_dispatch``,
        ``emit_kernels``, ``pack``; the native frontend's
        ``pipeline_chunks`` counts the chunks emitted;
        with the device frontend ``win_prep``, ``matchfind``, ``arbitrate``,
        ``merge`` and ``select`` in place of ``frontend``), the emission's
        bytes sent up and brought back (``upload_bytes``,
        ``download_bytes``) and, on a card, the CUDA-event milliseconds of
        its upload, E tables and kernels, and download under
        ``detail_device``. The device frontend adds ``detail_match``, one
        dict per window size (see ``_windows_compact_grouped``). With
        ``device_emission=False`` the stages are ``small``, ``win_prep``,
        ``matchfind``, ``arbitrate``, ``merge`` and ``select_emit`` (the
        host's selection and emission), with ``detail_match``; there is no
        ``detail_device``, ``upload_bytes`` or ``download_bytes``. The
        calling thread's CPU seconds in each stage go under ``detail_cpu``
        and, under an active ``torch.profiler`` session, the call is a
        ``lzfse.encode_many`` range with a ``lzfse.encode.<stage>`` range a
        stage inside it, as ``TorchDecoder.decode_many`` records them.
        Not re-entrant: the staging buffers belong to the encoder."""
        with _Clock(stats, "encode") as clock:
            return self._encode_many(sources, stats, clock)

    def _encode_many(self, sources, stats, clock: _Clock) -> list[bytes]:
        """``encode_many``'s work, its stages closed on ``clock``."""
        clock.begin("small")
        results: list = [None] * len(sources)
        big: list[int] = []
        for i, s in enumerate(sources):
            if len(s) <= C.VN_CUTOFF:
                results[i] = self._native.encode_bytes(s)
            else:
                big.append(i)
        clock.mark("small")
        if not big:
            return results
        if self._windows_path:
            return self._encode_many_device(sources, big, results, stats,
                                            clock)
        n_chunks = min(max(int(os.environ.get("LZT_ENC_CHUNKS", "1")), 1),
                       len(big))
        pool, nb, out_lists, nb_of, chunks = self._frontends(
            sources, big, clock, n_chunks, emit=True)
        glo, gmeta, lfs, mlo, mmeta, mfs = self._emit_wait(chunks, nb, stats,
                                                           clock)
        if stats is not None:
            stats["pipeline_chunks"] = len(chunks)

        clock.begin("pack")
        cap = self._native.PACK_SLOT_CAP
        if self._arena is None or self._arena.size < nb * cap:
            self._arena = np.empty(nb * cap, np.uint8)
        lens = np.zeros(nb, np.int64)
        a = pool.a
        self._native.pack_stage(glo, gmeta, mlo, mmeta, lfs, mfs,
                                a["lit_num"], a["lmd_num"], a["meta"],
                                a["wpay"], a["wpay_len"], nb, self._arena,
                                lens)
        arena = self._arena

        def body(s: int):
            return arena[s * cap:s * cap + int(lens[s])]

        for i in big:
            parts = []
            for s in out_lists[i][:nb_of[i]]:
                s = int(s)
                alt = int(a["meta"][s, 2])
                # emit_best: the strictly smaller variant wins, ties keep
                # the block as it is
                parts.append(body(alt) if alt >= 0 and lens[alt] < lens[s]
                             else body(s))
            results[i] = b"".join(parts) + EOS
        clock.mark("pack")
        self.last_emission = "device"
        return results

    def encode_bytes(self, src: bytes) -> bytes:
        """Encode one source: the frontend's blocks, emitted on the device
        one block per slot (with ``device_emission=False``, the device
        windows' matches selected and emitted on the host).
        Byte-identical to ``native.encode_bytes``."""
        if len(src) <= C.VN_CUTOFF:
            return self._native.encode_bytes(src)
        if not self._windows_path:
            blocks = _parse_blocks(self._native.frontend_blocks(src))
        elif self.device_emission:
            blocks = self._select_blocks(src, self._device_matches(src, False))
        else:
            body = self._native.select_emit_fse(
                src, _stream_rows(self._device_matches(src, False)))
            self.last_emission = "host"
            return body + EOS
        body = b"".join(self._emit_best(blocks))
        self.last_emission = "device"
        return body + EOS

    def kernel_args(self, sources: list[bytes]) -> tuple[dict, dict]:
        """The two kernels' arguments for a batch, on this encoder's
        device: ``(encode_literals kwargs, encode_lmds kwargs)``, as
        ``encode_many`` passes them. On CPU they are views of the staging
        pool, valid until the next call."""
        big = [i for i, s in enumerate(sources) if len(s) > C.VN_CUTOFF]
        if not big:
            raise ValueError("no source is above VN_CUTOFF: nothing to emit")
        pool, nb, _, _, _ = self._frontends(sources, big)
        return self._kwargs(self._upload(pool, 0, nb))

    def match_args(self, sources: list[bytes], wins: list) -> list[dict]:
        """``match_rows``'s arguments (all but ``vn``) for the windows
        ``wins`` (a subset of ``windows(sources)``), one dict per window
        size N in ascending order, on this encoder's device, as the device
        frontend passes them (``vn`` False)."""
        fulls = {w[0]: np.frombuffer(sources[w[0]], np.uint8) for w in wins}
        return [{k: t.to(self.device, copy=True) for k, t in
                 self._window_inputs(fulls, [wins[k] for k in idxs], N,
                                     False).items()}
                for N, idxs in _by_n(wins)]

    @staticmethod
    def windows(sources: list[bytes]) -> list[tuple]:
        """Every device-frontend window of the sources above ``VN_CUTOFF``:
        ``(source index, base, ctx, n, N)``, in source order."""
        return [w for i, s in enumerate(sources) if len(s) > C.VN_CUTOFF
                for w in _source_windows(i, len(s))]

    # -- device frontend -------------------------------------------------

    def _encode_many_device(self, sources, big, results, stats, clock):
        """``encode_many`` with the device frontend (``TpuEncoder``'s
        ``frontend="device"`` branch): windowed device match finding, then
        native selection and one emission pass over every block; with
        ``device_emission=False``, ``native.select_emit_fse`` per source on
        host threads instead."""
        clock.begin("win_prep")
        wins = self.windows(sources)
        fulls = {i: np.frombuffer(sources[i], dtype=np.uint8) for i in big}
        clock.mark("win_prep")
        win_out = self._windows_compact(fulls, wins, False, stats, clock)
        parts: dict = {i: [] for i in big}
        for k, w in enumerate(wins):
            parts[w[0]].append(win_out[k])
        clock.begin("merge")
        streams = {i: _merge(fulls[i], parts[i]) for i in big}
        clock.mark("merge")
        if not self.device_emission:
            clock.begin("select_emit")
            bodies = _map(lambda i: self._native.select_emit_fse(
                sources[i], _stream_rows(streams[i])), big)
            for i, body in zip(big, bodies):
                results[i] = body + EOS
            clock.mark("select_emit")
            self.last_emission = "host"
            return results
        clock.begin("select")
        per_src = {i: self._select_blocks(sources[i], streams[i]) for i in big}
        clock.mark("select")
        flat: list = []
        spans: dict = {}
        for i in big:
            spans[i] = (len(flat), len(per_src[i]))
            flat.extend(per_src[i])
        bodies = self._emit_best(flat, stats, clock)
        clock.begin("pack")
        for i in big:
            off, cnt = spans[i]
            results[i] = b"".join(bodies[off:off + cnt]) + EOS
        clock.mark("pack")
        self.last_emission = "device"
        return results

    def _device_matches(self, src: bytes, vn: bool) -> MatchStream:
        """One source's match stream through its device windows."""
        full = np.frombuffer(src, dtype=np.uint8)
        wins = _source_windows(0, len(src))
        win_out = self._windows_compact({0: full}, wins, vn)
        return _merge(full, [win_out[k] for k in range(len(wins))])

    def _select_blocks(self, src: bytes, stream: MatchStream):
        """Native selection and block splitting of a match stream, without
        emission: the raw blocks ``_emit_best`` takes."""
        return _parse_blocks(self._native.select_blocks(src,
                                                        _stream_rows(stream)))

    def _window_inputs(self, fulls: dict, wins: list, N: int,
                       vn: bool, n_rows: int | None = None) -> dict:
        """Host tensors (pinned for a card, reused across calls) of
        ``match_rows``'s arguments for windows of size N: each window's
        bytes, zero-padded to N, and its positions grouped by hash bucket
        (``native.match_group``, on a host thread pool). Rows past the
        windows, up to ``n_rows``, are inert, as the JAX encoder pads a
        mesh's batch: zero bytes, ``n_real`` 4, an empty payload range, the
        identity order and no candidate bits."""
        B = len(wins)
        R = B if n_rows is None else n_rows
        t = {"pads": self._host("pads", (R, N), torch.uint8),
             "n_reals": self._host("n_reals", (R,), torch.int32),
             "los": self._host("los", (R,), torch.int32),
             "his": self._host("his", (R,), torch.int32),
             "orders": self._host("orders", (R, N), torch.int32),
             "oks": self._host("oks", (R, N), torch.uint8)}
        a = {k: v.numpy() for k, v in t.items()}

        def group(r):
            i, base, ctx, n, _ = wins[r]
            a["pads"][r, :n] = fulls[i][base:base + n]
            a["pads"][r, n:] = 0
            a["n_reals"][r], a["los"][r] = n, ctx
            a["his"][r] = ctx + WINDOW_STRIDE
            a["orders"][r], a["oks"][r] = self._native.match_group(
                a["pads"][r], n, vn)

        _map(group, range(B))
        a["pads"][B:] = 0
        a["n_reals"][B:] = 4
        a["los"][B:] = a["his"][B:] = 0
        a["orders"][B:] = np.arange(N, dtype=np.int32)
        a["oks"][B:] = 0
        return t

    def _windows_compact(self, fulls: dict, wins: list, vn: bool,
                         stats: dict | None = None,
                         clock: _Clock | None = None) -> dict:
        """Match rows of every window, as ``TpuEncoder._windows_compact``
        reads ``LZT_DEV_GROUPED``: at ``"1"`` (the default) the sort-free
        grouped path (``_windows_compact_grouped``), at any other value the
        argsort branch below. Same return contract either way: window
        index -> (abs_pos, best_cand, best_len).

        The argsort branch runs ``ops/match_find.find_matches_compact``
        (torch ops on this encoder's device; a mesh is not used, as the
        JAX branch does not use it) on the windows of one window size N
        at a time: each window's bytes zero-padded to N, uploaded
        (``win_prep``); on the device every position's candidates by a
        stable sort of hash buckets, the LCPs and the arbitration, each
        window's slots ordered saturated first, then matched; the counts
        read back, then only the first ``kmax`` matched and ``smax``
        saturated columns brought back, both widths bucketed to powers of
        two (``matchfind``); the saturated slots re-extended exactly on
        the host by ``_arbitrate_window`` (``arbitrate``). With ``stats``,
        each window size appends to ``stats["detail_match"]`` its N,
        window count, slots, saturated and matched slots, bytes up and
        down, stage seconds and, on a card, the CUDA-event ms of the
        upload, the match finding with the counts' read, and the
        download."""
        if os.environ.get("LZT_DEV_GROUPED", "1") == "1":
            return self._windows_compact_grouped(fulls, wins, vn, stats,
                                                 clock)
        clock = clock or _Clock(stats)
        cuda = self.device.type == "cuda"
        out: dict = {}
        for N, idxs in _by_n(wins):
            clock.begin("win_prep")
            B = len(idxs)
            host = {"pads": self._host("pads", (B, N), torch.uint8),
                    "n_reals": self._host("n_reals", (B,), torch.int32),
                    "los": self._host("los", (B,), torch.int32),
                    "his": self._host("his", (B,), torch.int32)}
            a = {k: v.numpy() for k, v in host.items()}
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                a["pads"][r, :n] = fulls[i][base:base + n]
                a["pads"][r, n:] = 0
                a["n_reals"][r], a["los"][r] = n, ctx
                a["his"][r] = ctx + WINDOW_STRIDE
            prep_s = clock.mark("win_prep")
            clock.begin("matchfind")
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            if cuda:
                ev[1].record()
            counts, pos_s, cand_s, len_s, cands_s, lcps_s = \
                MF.find_matches_compact(dev["pads"], dev["n_reals"],
                                        dev["los"], dev["his"], vn)
            counts_h = counts.cpu().numpy()
            if cuda:
                ev[2].record()
            # bucketed slice widths, as the JAX branch cuts its downloads
            kmax = min(_bucket_pow2(max(int(counts_h[:, 1].max()), 1),
                                    4096), N)
            smax = min(_bucket_pow2(max(int(counts_h[:, 0].max()), 1),
                                    1024), N)
            rows = [x.cpu() for x in (pos_s[:, :kmax], cand_s[:, :kmax],
                                      len_s[:, :kmax], cands_s[:, :, :smax],
                                      lcps_s[:, :, :smax])]
            if cuda:
                ev[3].record()
                ev[3].synchronize()
            del dev, counts, pos_s, cand_s, len_s, cands_s, lcps_s
            pos_h, cand_h, len_h = (x.numpy().astype(np.int64)
                                    for x in rows[:3])
            cands_h, lcps_h = (x.numpy() for x in rows[3:])
            find_s = clock.mark("matchfind")
            clock.begin("arbitrate")
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                S, K_ = int(counts_h[r, 0]), int(counts_h[r, 1])
                if S:
                    sp, sc, sl = _arbitrate_window(
                        fulls[i], base, ctx, n, pos_h[r, :S],
                        cands_h[r, :, :S], lcps_h[r, :, :S], vn)
                else:
                    sp = sc = sl = np.zeros(0, np.int64)
                out[k] = (np.concatenate([sp, pos_h[r, S:K_] + base]),
                          np.concatenate([sc, cand_h[r, S:K_] + base]),
                          np.concatenate([sl, len_h[r, S:K_]]))
            arb_s = clock.mark("arbitrate")
            if stats is not None:
                det = {"N": N, "windows": B, "slots": B * N,
                       "sat": int(counts_h[:, 0].sum()),
                       "matched": int(counts_h[:, 1].sum()),
                       "upload_bytes": sum(x.nbytes for x in host.values()),
                       "download_bytes": counts_h.nbytes + sum(
                           x.nbytes for x in rows),
                       "win_prep_s": prep_s, "matchfind_s": find_s,
                       "arbitrate_s": arb_s}
                if cuda:
                    det.update(upload_ms=ev[0].elapsed_time(ev[1]),
                               kernel_ms=ev[1].elapsed_time(ev[2]),
                               download_ms=ev[2].elapsed_time(ev[3]))
                stats.setdefault("detail_match", []).append(det)
        return out

    def _windows_compact_grouped(self, fulls: dict, wins: list, vn: bool,
                                 stats: dict | None = None,
                                 clock: _Clock | None = None) -> dict:
        """Match rows of every window ``(src_idx, base, ctx, n, N)`` of the
        sources ``fulls``: window index -> (abs_pos, best_cand, best_len).

        Per window size N: ``_window_inputs`` (``win_prep``); one upload,
        one ``match_rows`` launch (the matched and saturated slots,
        compacted on the device, and a read of their totals), one download
        of those rows (``matchfind``); ``_arbitrate_window`` on the
        saturated slots, the matched ones as they are (``arbitrate``). With
        ``stats``, each window size appends to ``stats["detail_match"]`` its
        N, window count, slots, saturated and matched slots, bytes up and
        down, the seconds of its three stages (``win_prep_s``,
        ``matchfind_s``, ``arbitrate_s``) and, on a card, the CUDA-event ms
        of the upload, the kernel with its totals' read, and the
        download; with a mesh, in place of the first two, the whole
        sharded call (``sharded_ms``: every shard's upload and kernel, the
        totals' reads, the rows' gather on the first device)."""
        clock = clock or _Clock(stats)
        cuda = self.device.type == "cuda"
        out: dict = {}
        for N, idxs in _by_n(wins):
            clock.begin("win_prep")
            B = len(idxs)
            n_rows = B if self.mesh is None else _round_up(B, self.mesh.size)
            host = self._window_inputs(fulls, [wins[k] for k in idxs], N, vn,
                                       n_rows)
            prep_s = clock.mark("win_prep")
            clock.begin("matchfind")
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
            if self.mesh is None:
                dev = {k: v.to(self.device, non_blocking=True)
                       for k, v in host.items()}
                if cuda:
                    ev[1].record()
                rows = MF.match_rows(**dev, vn=vn)
                del dev
            else:
                # every shard uploads its windows and launches before any
                # total is read; the rows come back on the first device
                if cuda:
                    ev[1].record()
                rows = sharded_grouped_match(self.mesh, **host, vn=vn)
            if cuda:
                ev[2].record()
                down = [self._host(f"down{j}", tuple(x.shape), x.dtype)
                        for j, x in enumerate(rows)]
                for h, x in zip(down, rows):
                    h.copy_(x, non_blocking=True)
                ev[3].record()
                ev[3].synchronize()
            else:
                down = rows
            offs, matched, m_len, sat = (x.numpy() for x in down)
            del rows
            find_s = clock.mark("matchfind")
            clock.begin("arbitrate")
            orders = host["orders"].numpy()
            for r, k in enumerate(idxs):
                i, base, ctx, n, _ = wins[k]
                sr = sat[offs[r, 1]:offs[r + 1, 1]]
                if len(sr):
                    sp, sc, sl = _arbitrate_window(
                        fulls[i], base, ctx, n, orders[r][sr[:, 0]],
                        sr[:, 1:1 + C.HASH_WIDTH].T,
                        sr[:, 1 + C.HASH_WIDTH:].T, vn)
                else:
                    sp = sc = sl = np.zeros(0, np.int64)
                mr = matched[offs[r, 0]:offs[r + 1, 0]]
                dp = orders[r][mr[:, 0]].astype(np.int64) + base
                dc = mr[:, 1].astype(np.int64) + base
                dl = m_len[offs[r, 0]:offs[r + 1, 0]].astype(np.int64)
                out[k] = (np.concatenate([sp, dp]), np.concatenate([sc, dc]),
                          np.concatenate([sl, dl]))
            arb_s = clock.mark("arbitrate")
            if stats is not None:
                det = {"N": N, "windows": B, "slots": B * N,
                       "sat": len(sat), "matched": len(matched),
                       "upload_bytes": sum(x.nbytes for x in host.values()),
                       "download_bytes": sum(x.nbytes for x in (
                           offs, matched, m_len, sat)),
                       "win_prep_s": prep_s, "matchfind_s": find_s,
                       "arbitrate_s": arb_s}
                if cuda and self.mesh is None:
                    det.update(upload_ms=ev[0].elapsed_time(ev[1]),
                               kernel_ms=ev[1].elapsed_time(ev[2]),
                               download_ms=ev[2].elapsed_time(ev[3]))
                elif cuda:
                    # on the first device: the whole sharded call (every
                    # shard's upload and kernel, the totals' reads, the
                    # rows' gather), then the download
                    det.update(sharded_ms=ev[1].elapsed_time(ev[2]),
                               download_ms=ev[2].elapsed_time(ev[3]))
                stats.setdefault("detail_match", []).append(det)
        return out

    # -- per-block staging (encode_bytes, the device frontend) -----------

    def _emit_best(self, blocks, stats: dict | None = None,
                   clock: _Clock | None = None) -> list:
        """Block bodies with the period-split decision (emit_best): a block
        with an eligible alternative emits both row forms in the same pass
        and the strictly smaller body wins (ties keep the block as is).
        ``stats`` and ``clock`` as in ``_emit_wait``."""
        flat = list(blocks)
        alt_of: dict[int, int] = {}
        for bi, (lits, rows, n_mb) in enumerate(blocks):
            alt = F.period_split_rows(rows)
            if alt is not None:
                alt_of[bi] = len(flat)
                flat.append((lits, alt, n_mb))
        bodies = self._emit_blocks(flat, stats, clock or _Clock(stats))
        out = []
        for bi in range(len(blocks)):
            j = alt_of.get(bi)
            out.append(bodies[j] if j is not None
                       and len(bodies[j]) < len(bodies[bi]) else bodies[bi])
        return out

    def _emit_blocks(self, blocks, stats: dict | None,
                     clock: _Clock) -> list:
        """One body per block: weights and rows staged per block, both
        kernels over all blocks at once, groups packed per block."""
        clock.begin("emit_prep")
        nb = len(blocks)
        pool = self._staging(nb)
        a = pool.a
        w_payloads: list = [b""] * nb

        def stage(i):
            lits, rows3, _ = blocks[i]
            a["weights"][i], w_payloads[i] = self._native.block_weights(
                rows3, lits)
            n_lit = len(lits)
            pad = (-n_lit) % 4
            start = N_COLS * 4 - (n_lit + pad)
            a["litw"][i, start:start + n_lit] = lits
            a["litw"][i, start + n_lit:start + n_lit + pad] = \
                lits[0] if n_lit else 0
            a["lit_num"][i] = n_lit + pad
            nr = len(rows3)
            a["lmv"][i, N_COLS - nr:] = rows3[:, 0] | (rows3[:, 1] << 16)
            a["dv"][i, N_COLS - nr:] = rows3[:, 2]
            a["lmd_num"][i] = nr

        _map(stage, range(nb))
        glo, gmeta, lfs, mlo, mmeta, mfs = self._emit_wait(
            [self._emit_chunk(pool, 0, nb, clock)], nb, stats, clock)

        def pack(i):
            lits, _, n_mb = blocks[i]
            padded = int(a["lit_num"][i])
            lit_pay, lit_off = self._native.pack_groups(glo[i], gmeta[i],
                                                        padded // 4, 8)
            lmd_pay, lmd_off = self._native.pack_groups(
                mlo[i], mmeta[i], int(a["lmd_num"][i]), 22)
            lmd_pay = b"\x00" * 8 + lmd_pay
            lit_param = F.LiteralParam(
                num=padded, n_payload_bytes=len(lit_pay), bits=lit_off,
                state=tuple(int(s) - C.U_STATES for s in lfs[i]))
            lmd_param = F.LmdParam(
                num=int(a["lmd_num"][i]), n_payload_bytes=len(lmd_pay),
                bits=lmd_off,
                state=(int(mfs[i, 0]) - C.L_STATES,
                       int(mfs[i, 1]) - C.M_STATES,
                       int(mfs[i, 2]) - C.D_STATES))
            block = F.FseBlock(lit_param, lmd_param, len(lits) + n_mb)
            return b"".join((F.store_v2_header(block, len(w_payloads[i])),
                             w_payloads[i], lit_pay, lmd_pay))

        return _map(pack, range(nb))
