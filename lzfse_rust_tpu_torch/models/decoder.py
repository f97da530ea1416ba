"""TorchDecoder -- batched LZFSE container decode on a CUDA device.

Counterpart of ``lzfse_rust_tpu.models.decoder`` (``TpuDecoder.decode_many``
with ``_walk_front``/``_walk_back``). The host layers are the port's own
copies of the JAX package's (``base``, ``spec``, ``runtime/native.py`` and
the C++ runtime, and the container-parse helpers below): the native
container walk, table build, payload gather and flatten/rebuild, and the
spec layer for exact errors.

Every call runs three stages, whatever the options:

1. front: ``native.walk`` parses the batch; a container the walk rejects
   is re-parsed by ``_parse_container`` (raising the precise exception) or
   decoded by the spec layer. Then the FSE stage's host half (``prep``)
   stages the FSE blocks for the device.
2. FSE stage (``device``), chosen by ``use_kernels``: the two stream-decode
   kernels of ``ops/cuda_decode.py`` (blocks size-sorted, tables built and
   payloads gathered straight into one staging buffer, pinned on a card,
   uploaded by one ``non_blocking`` copy; the literal and L/M/D kernels on
   two CUDA streams), or the torch-op scans (``ops/table_build``,
   ``ops/fse_decode``) on payloads gathered into padded rows. Either
   leaves on the device the literal bytes, ``lm`` and raw ``d`` of every
   block with each block's row and literal offsets and counts, and each
   stream's final states and bit position (``_Batch``, ``_fse``).
3. rebuild, chosen by ``use_native_rebuild``: the outputs come back in one
   pinned buffer, the host checks each stream's final states and
   position, then ``native.flatten_rebuild`` writes every container's
   bytes; or the outputs stay on the device, are flattened there into each
   container's row stream and literal pool with its LZVN/RAW parts
   (``ops/lz_rebuild.flatten_pieces``), the rebuild kernel of
   ``ops/cuda_rebuild.py`` writes the bytes, and only the final states,
   the checks and the output bytes come back. A failed check or rebuild
   sends the container to the spec layer and counts in
   ``stats["fallbacks"]``.

With a ``mesh`` (``parallel/mesh.py``; kernels and native rebuild only)
the upload sends each shard's region of the staging buffer to its own
device and both kernels run on every shard
(``parallel/mesh.launch_decode``); the outputs come back into the one host
buffer in batch order, so the rebuild is unchanged.

``device="cpu"`` runs the kernels' plain versions; it exists for the
tests. A CUDA device without a card raises: there is no silent CPU path.
"""

from __future__ import annotations

import ctypes as _ct
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from itertools import compress

import numpy as np
import torch

from ..base import constants as C
from ..base.errors import (BadBlock, DecodeError, LzfseError, PayloadOverflow,
                           PayloadUnderflow)
from ..ops import cuda_decode as K
from ..ops import cuda_rebuild as CR
from ..ops import fse_decode as FD
from ..ops import lz_rebuild as LR
from ..ops import table_build as TB
from ..parallel.mesh import Mesh, launch_decode
from ..runtime import native
from ..runtime.build import native_runtime
from ..spec import container as spec_container
from ..spec import fse as F
from ..spec import vn as V
from ..spec import weights as W
from ..utils.buffers import _round_up, download, download_groups, host_buffer
from ..utils.timing import _Clock

# --- host helpers, copied from lzfse_rust_tpu/models/decoder.py ------------


@dataclass
class _FseBlockDesc:
    container: int
    order: int  # position among the container's blocks
    block: F.FseBlock
    weights: np.ndarray
    lit_payload: bytes  # includes leading 8 borrowed/pad bytes
    lmd_payload: bytes  # includes its own leading 8 pad bytes


@dataclass
class _ParsedContainer:
    # per-block entries in stream order: ("fse", fse_index) | rows/literals
    parts: list = field(default_factory=list)
    n_raw: int = 0


_NATIVE_W = None


def _native_mod():
    """The native runtime module, or None when the .so is absent."""
    global _NATIVE_W
    if _NATIVE_W is None:
        try:
            from ..runtime import native
            _NATIVE_W = native if native.available() else False
        except Exception:
            _NATIVE_W = False
    return _NATIVE_W or None


def _weights_v2(payload: bytes) -> np.ndarray:
    """V2 weight Huffman decode — native engine when built (the Python
    nibble loop costs ~0.3ms/block and dominated host parse)."""
    n = _native_mod()
    if n is not None:
        return n.load_weights_v2(payload)
    return W.load_v2(payload)


def _parse_container(src: bytes, ci: int, fse_blocks: list) -> _ParsedContainer:
    """Walk one container, collecting FSE payloads and host-parsed rows."""
    out = _ParsedContainer()
    pos = 0
    n = len(src)
    while True:
        if n - pos < 4:
            raise PayloadUnderflow("container truncated")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic == C.MAGIC_EOS:
            pos += 4
            break
        if magic in (C.MAGIC_VX2, C.MAGIC_VX1):
            if magic == C.MAGIC_VX2:
                block, nw = F.load_v2_header(
                    spec_container._take(src, pos, C.V2_HEADER_SIZE))
                weights = _weights_v2(
                    spec_container._take(src, pos + C.V2_HEADER_SIZE, nw))
                payload_start = pos + C.V2_HEADER_SIZE + nw
            else:
                block = F.load_v1_header(
                    spec_container._take(src, pos, C.V1_HEADER_SIZE))
                weights = W.load_v1(spec_container._take(
                    src, pos + C.V1_HEADER_SIZE, C.V1_WEIGHT_PAYLOAD_BYTES))
                payload_start = pos + C.V1_HEADER_SIZE + C.V1_WEIGHT_PAYLOAD_BYTES
            lit_payload = spec_container._take(
                src, payload_start - 8, block.literal.n_payload_bytes + 8)
            lmd_start = payload_start + block.literal.n_payload_bytes
            lmd_payload = spec_container._take(
                src, lmd_start, block.lmd.n_payload_bytes)
            # BitReader init padding checks (bit_reader.rs:25-27).
            for payload, bits in ((lit_payload, block.literal.bits),
                                  (lmd_payload, block.lmd.bits)):
                if bits and int.from_bytes(payload[-8:], "little") >> (64 - bits):
                    raise DecodeError("BadBitStream")
            out.parts.append(("fse", len(fse_blocks)))
            fse_blocks.append(_FseBlockDesc(
                ci, len(out.parts) - 1, block, weights, lit_payload,
                lmd_payload))
            out.n_raw += block.n_raw_bytes
            pos = lmd_start + block.lmd.n_payload_bytes
        elif magic == C.MAGIC_VXN:
            header = spec_container._take(src, pos, C.VN_HEADER_SIZE)
            n_raw_b = int.from_bytes(header[4:8], "little")
            n_pay = int.from_bytes(header[8:12], "little")
            payload = spec_container._take(src, pos + C.VN_HEADER_SIZE, n_pay)
            rows, lits = V.parse_vn_rows(payload, n_raw_b, n_pay)
            out.parts.append(("rows", rows, lits))
            out.n_raw += n_raw_b
            pos += C.VN_HEADER_SIZE + n_pay
        elif magic == C.MAGIC_RAW:
            header = spec_container._take(src, pos, C.RAW_HEADER_SIZE)
            n_raw_b = int.from_bytes(header[4:8], "little")
            data = spec_container._take(src, pos + C.RAW_HEADER_SIZE, n_raw_b)
            rows = np.array([[n_raw_b, 0, 0]], dtype=np.int32)
            out.parts.append(("rows", rows, data))
            out.n_raw += n_raw_b
            pos += C.RAW_HEADER_SIZE + n_raw_b
        else:
            raise BadBlock(magic)
    if n - pos != 0:
        raise PayloadOverflow("trailing bytes after EOS")
    return out


_ALIGN = 512  # payload alignment in the flat upload cat (128 int32 words)

def _put(results: list, at: np.ndarray, values) -> None:
    """``results[at[k]] = values[k]`` for every k, the loop run by ``map``."""
    deque(map(results.__setitem__, at.tolist(), values), maxlen=0)


# --- the port's decoder ------------------------------------------------------

# per-block int32 parameters, one row of B each, in the staging buffer
_ROWS = ("lit_pos", "lmd_pos", "lit_num", "lmd_num", "lit_off", "lmd_off",
         "lit_len", "lmd_len", "tot", "lit_out", "lmd_out")
_W = _ALIGN // 4  # payload chunk, in int32 words


def _stream_ok(lit_fs, lit_fp, lmd_fs, lmd_fp) -> np.ndarray:
    """Per block (rows in block order): final states at their defaults and
    no payload underflow, >= 64 bits of pad left (fse_core.rs:132-140 +
    literals.rs:79-87)."""
    lit_ok = (lit_fs == 0).all(axis=1) & (lit_fp >= 64)
    lmd_ok = ((lmd_fs[:, 0] == 0) & (lmd_fs[:, 1] == C.L_STATES)
              & (lmd_fs[:, 2] == C.L_STATES + C.M_STATES) & (lmd_fp >= 64))
    return lit_ok & lmd_ok


def _flatten_plan(parts, cpo, cont_nraw, cont_ok, fse_ok, row_off, lit_off):
    """The native rebuild's inputs for a walked batch, as array operations
    over its parts (``native.walk_batch``'s ``parts``, ``cont_part_off``,
    ``cont_nraw`` and ``cont_ok``), each FSE block's stream check
    ``fse_ok`` and its L/M/D word offset ``row_off`` and literal byte
    offset ``lit_off`` in the FSE stage's outputs. Returns (kept, failed,
    parts, cont_off, out_offs): the containers the walk accepted whose FSE
    blocks all passed, in order; those with a block that failed, in order
    (the spec layer decodes them); the kept containers' parts, each FSE
    part pointed at its block's outputs (``P[1]`` the L/M/D word offset,
    ``P[4]`` the literal byte offset); and the kept containers' part and
    output offsets."""
    n = len(cont_ok)
    owner = np.repeat(np.arange(n), np.diff(cpo))
    fse = parts[:, 0] == 0
    bad = np.bincount(owner[fse][~fse_ok[parts[fse, 1]]], minlength=n) > 0
    ok = cont_ok != 0
    keep = ok & ~bad
    kept = np.flatnonzero(keep)
    parts_np = parts[keep[owner]]
    if len(parts_np):
        k0 = parts_np[:, 0] == 0
        if k0.any():
            g = parts_np[k0, 1]
            parts_np[k0, 1] = row_off[g]
            parts_np[k0, 4] = lit_off[g]
    cont_off = np.zeros(len(kept) + 1, np.int32)
    np.cumsum(np.diff(cpo)[kept], out=cont_off[1:])
    out_offs = np.zeros(len(kept) + 1, np.int64)
    np.cumsum(cont_nraw[kept], out=out_offs[1:])
    return kept, np.flatnonzero(ok & bad), parts_np, cont_off, out_offs


# the walk's part kinds whose output the card takes part in, by rebuild: the
# native rebuild decodes LZVN (2) and RAW (3) parts on host threads, the
# device rebuild writes every part's output on the card
_CARD_KINDS = {True: (0,), False: (0, 2, 3)}


def _part_counts(parts, cpo, cont_nraw, cont_ok, card_kinds) -> dict:
    """What a walked batch holds, as array operations over its parts (the
    walk gives a rejected container no part): the containers, the accepted
    ones with no part of a kind in ``card_kinds`` (``host_only``: the path
    decodes them on the host alone) and their raw bytes, the raw bytes of
    every accepted container, and the parts of each kind."""
    n = len(cont_ok)
    kind = parts[:, 0]
    card = np.flatnonzero(np.isin(kind, card_kinds))
    # each such part's container: the last whose first part is at or
    # before it (a container without parts shares its first part's index)
    owner = np.searchsorted(cpo, card, side="right") - 1
    ok = cont_ok != 0
    host_only = ok & (np.bincount(owner, minlength=n) == 0)
    return {"containers": n, "host_only": int(np.count_nonzero(host_only)),
            "host_only_bytes": int(cont_nraw[host_only].sum()),
            "raw_bytes": int(cont_nraw[ok].sum()),
            "fse_blocks": int(np.count_nonzero(kind == 0)),
            "vn_blocks": int(np.count_nonzero(kind == 2)),
            "raw_blocks": int(np.count_nonzero(kind == 3))}


def _spec(sources, ci: int, stats: dict | None) -> bytes:
    """Container ci through the spec layer (its exact bytes or exception),
    counted in ``stats["fallbacks"]``."""
    if stats is not None:
        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
    return spec_container.decode_bytes(sources[ci])


def _add_ms(stats: dict | None, spans) -> None:
    """Add each (key, start event, end event)'s CUDA-event milliseconds to
    ``stats["detail_device"]``."""
    if stats is None:
        return
    det = stats.setdefault("detail_device", {})
    for key, a, b in spans:
        det[key] = det.get(key, 0.0) + a.elapsed_time(b)


def _add_device_ms(stats: dict | None, devices, upload, kernels, ends,
                   per_shard: bool) -> None:
    """The decode stage's CUDA-event milliseconds into
    ``stats["detail_device"]``: on each device, from its first shard's
    upload to its last's (``upload_ms``), from its first shard's kernels
    to its last's (``kernels_ms``), and from there to the end of its
    downloads (``download_ms``), each the largest over the devices; with
    ``per_shard``, each shard's own kernel milliseconds
    (``shard_kernels_ms``)."""
    if stats is None:
        return
    spans: dict = {}
    for k, dev in enumerate(devices):
        first, _ = spans.get(dev, (k, k))
        spans[dev] = (first, k)
    det = stats.setdefault("detail_device", {})
    for key, ms in (
            ("upload_ms", [upload[a][0].elapsed_time(upload[b][1])
                           for a, b in spans.values()]),
            ("kernels_ms", [kernels[a][0].elapsed_time(kernels[b][1])
                            for a, b in spans.values()]),
            ("download_ms", [kernels[b][1].elapsed_time(ends[dev])
                             for dev, (_, b) in spans.items()])):
        det[key] = det.get(key, 0.0) + max(ms)
    if per_shard:
        shard_ms = [a.elapsed_time(b) for a, b in kernels]
        old = det.get("shard_kernels_ms", [0.0] * len(shard_ms))
        det["shard_kernels_ms"] = [x + y for x, y in zip(old, shard_ms)]


def _walk_parts(src: bytes, sub: np.ndarray) -> list:
    """A container's walk parts as flatten parts: ``("fse", block)`` for an
    FSE block, ``("rows", rows, literals)`` for an LZVN block (parsed by
    ``spec.vn.parse_vn_rows``, which raises on a malformed payload) or a
    RAW block (one row (n_raw, 0, 0), its body as literals)."""
    parts = []
    for kind, a, b, c, _, _ in sub.tolist():
        if kind == 0:
            parts.append(("fse", a))
        elif kind == 2:
            parts.append(("rows", *V.parse_vn_rows(src[a:a + b], c, b)))
        else:
            parts.append(("rows", np.array([[b, 0, 0]], np.int32),
                          np.frombuffer(src, np.uint8, b, a)))
    return parts


_COPY_CHUNK = 1 << 20


def copy_segments(base: int, spans, pool) -> list[bytes]:
    """New bytes objects holding the host memory at ``base + a`` to
    ``base + b`` for each (a, b) of ``spans``, made by one
    ``native.new_outputs`` call and filled in 1 MiB pieces by the threads of
    ``pool`` (``ctypes.memmove`` releases the GIL)."""
    spans = np.array(list(spans), np.int64).reshape(-1, 2)
    res, dsts = native.new_outputs(spans[:, 1] - spans[:, 0])
    jobs = []
    for (a, b), dst in zip(spans.tolist(), dsts.tolist()):
        for o in range(a, b, _COPY_CHUNK):
            jobs.append((dst + o - a, base + o, min(_COPY_CHUNK, b - o)))
    for _ in pool.map(lambda j: _ct.memmove(*j), jobs):
        pass
    return res


@dataclass
class _Batch:
    """One call's FSE blocks as the FSE stage takes them, and where each
    block's outputs land. ``lit`` and ``lmd`` hold per shard the literal
    and L/M/D decoders' inputs on its device (the kernels' keyword
    arguments, or the scans' padded payloads, states, positions and
    counts), ``weights`` the scans' (nb, 360) weights. Per block, in block
    order: ``sl_n`` / ``sm_n`` its slot in the literal / L/M/D outputs (the
    shards' outputs concatenated), where its final states and position
    lie; ``rows`` its L/M/D word offset and count in ``lm`` and ``d``;
    ``lits`` its literal byte offset and count."""
    lit: list
    lmd: list
    sl_n: np.ndarray
    sm_n: np.ndarray
    rows: tuple   # (offsets, counts)
    lits: tuple
    weights: torch.Tensor | None = None
    upload: list | None = None   # per shard, CUDA events around its upload


def _no_blocks() -> _Batch:
    """The batch of a call without an FSE block."""
    e = np.zeros(0, np.int64)
    return _Batch([], [], e, e, (e, e), (e, e))


class TorchDecoder:
    """Batched container decoder whose FSE stream decode runs in the CUDA
    kernels of ``ops/cuda_decode.py`` (their plain versions on the CPU) or
    in the torch-op scans."""

    def __init__(self, device="cuda", use_kernels: bool = True,
                 use_native_rebuild: bool = True, mesh=None):
        """``use_kernels`` chooses the FSE stage, the counterpart of
        ``TpuDecoder``'s ``use_pallas``: True decodes the FSE streams in
        the CUDA kernels of ``ops/cuda_decode.py``; False in the portable
        path's decode tables and stream scans as torch ops
        (``ops/table_build``, ``ops/fse_decode``). ``use_native_rebuild``
        chooses the rebuild: True on the host (``native.flatten_rebuild``);
        False flattens and rebuilds on the device
        (``ops/lz_rebuild.flatten_pieces``, then the CUDA kernel of
        ``ops/cuda_rebuild.py``), so only the output bytes come back. The
        native container walk runs in front of every pair. The defaults
        are the serving path.

        ``mesh`` (``parallel/mesh.make_mesh``, devices of ``device``'s
        type): the size-sorted block batch, padded with inert slots to a
        multiple of the mesh size, splits into contiguous shards; each
        shard's slice of the staging buffer goes to its device, where both
        kernels decode it (``parallel/mesh.launch_decode``, the launch stage
        of ``sharded_pallas_entropy_decode``), and the outputs come back
        into one host buffer in batch order. The host stages are those of
        the default path, which is the only one with a mesh."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchDecoder: device 'cuda' requested "
                                   "but CUDA is not available")
        elif self.device.type != "cpu":
            raise ValueError(f"TorchDecoder: unsupported device {device!r}")
        self.use_kernels = bool(use_kernels)
        self.use_native_rebuild = bool(use_native_rebuild)
        if mesh is not None:
            if not (self.use_kernels and self.use_native_rebuild):
                raise ValueError("TorchDecoder: a mesh shards the kernel "
                                 "path; use_kernels and use_native_rebuild "
                                 "must be True")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"TorchDecoder: the mesh's devices "
                                 f"{mesh.devices} are not all of type "
                                 f"{self.device.type!r}")
        self.mesh = mesh
        # a decoder without a mesh is a one-shard mesh of its device
        self._mesh = mesh if mesh is not None else Mesh((self.device,))
        # the FSE stage (host half, device half) and the rebuild
        self._fse_prep, self._fse_run = (
            (self._prep, self._launch) if self.use_kernels
            else (self._scan_prep, self._scans))
        self._rebuild = (self._back if self.use_native_rebuild
                         else self._back_device)
        self._native = native_runtime()
        self._native.alloc_reuse()  # warm-page reuse for output bytes
        self._stage: torch.Tensor | None = None   # host staging, int32
        self._stage_free = []   # events: the last uploads from _stage are done
        self._down: torch.Tensor | None = None    # host download, int32
        self._out_pin: torch.Tensor | None = None  # pinned output bytes
        self._pool = None   # threads that copy output bytes out of it
        self._side = {}   # per device, the CUDA stream of the L/M/D kernel
        self._walked = (0, 0)   # the last walk's FSE blocks and parts

    # -- host buffers ----------------------------------------------------

    def _staging(self, n_words: int) -> torch.Tensor:
        # the previous call's uploads may still read this buffer: wait for
        # them before refilling
        for ev in self._stage_free:
            ev.synchronize()
        self._stage_free = []
        self._stage = host_buffer(self._stage, n_words,
                                  self.device.type == "cuda")
        return self._stage

    # -- pipeline --------------------------------------------------------

    def _front(self, sources: list[bytes], stats: dict | None, clock: _Clock):
        """Parse, then the FSE stage's host half (``prep``). Returns
        (results, frame); results holds spec-layer decodes of containers
        the walk rejected."""
        clock.begin("parse")
        results: list = [None] * len(sources)
        ptrs = self._native.src_ptrs(sources)
        # the first try holds the last call's blocks and parts, so a
        # decoder that sees one batch shape walks once a call
        (desc, w16, parts, cpo, cont_nraw, cont_ok), tries = \
            self._native.walk(ptrs, self._walked)
        self._walked = (len(desc), len(parts))
        if stats is not None:
            stats["walks"] = stats.get("walks", 0) + tries
            det = stats.setdefault("detail_parts", {})
            counts = _part_counts(parts, cpo, cont_nraw, cont_ok,
                                  _CARD_KINDS[self.use_native_rebuild])
            for k, v in counts.items():
                det[k] = det.get(k, 0) + v
        for ci in np.flatnonzero(cont_ok == 0):
            ci = int(ci)
            # exact error semantics: the Python parse raises the precise
            # exception; one that parses clean goes to the spec layer
            _parse_container(sources[ci], ci, [])
            results[ci] = _spec(sources, ci, stats)
        clock.mark("parse")
        if len(desc):
            batch = self._fse_prep(sources, ptrs, desc, w16, clock)
        else:
            clock.begin("prep")
            clock.mark("prep")
            batch = _no_blocks()
        return results, (batch, parts, cpo, cont_nraw, cont_ok, ptrs)

    # -- the FSE stage: the kernels (use_kernels=True) ------------------

    def _prep(self, sources, ptrs, desc, w16, clock: _Clock) -> _Batch:
        """The kernels' host half: the size sorts, the tables, the payloads
        and the per-block parameters straight into the staging buffer, and
        its upload, a region a shard."""
        clock.begin("prep_tables")
        nb = len(desc)
        n_sh = self._mesh.size
        S = -(-nb // n_sh)   # slots a shard
        B = S * n_sh         # the sorted batch; slots past nb are inert
        lit_n = desc[:, 1].astype(np.int64)
        lmd_n = desc[:, 2].astype(np.int64)
        # size-sorted slots: block i decodes in slot sl_n[i] / sm_n[i]
        perm_l = np.argsort(-K.literal_counts(lit_n), kind="stable")
        perm_m = np.argsort(-lmd_n, kind="stable")
        sl_n = np.argsort(perm_l).astype(np.int32)
        sm_n = np.argsort(perm_m).astype(np.int32)
        lens_l = desc[:, 6].astype(np.int64)
        lens_m = desc[:, 8].astype(np.int64)
        # payload chunks, shard by shard: each shard's literal payloads,
        # then its L/M/D payloads, each in block order; word offsets count
        # from the shard's first chunk
        chunks = (np.concatenate((lens_l, lens_m)) + _ALIGN - 1) // _ALIGN
        shard = np.concatenate((sl_n, sm_n)) // S
        order = np.argsort(shard, kind="stable")
        cum = np.cumsum(chunks[order])
        start = np.empty(2 * nb, np.int64)
        start[order] = cum - chunks[order]
        n_cat = np.bincount(shard, weights=chunks, minlength=n_sh).astype(
            np.int64) * _W
        start = start * _W - np.concatenate(([0], np.cumsum(n_cat)[:-1]))[
            shard]
        counts_l = np.zeros(B, np.int64)
        counts_l[:nb] = K.literal_counts(lit_n)[perm_l]
        counts_m = np.zeros(B, np.int64)
        counts_m[:nb] = lmd_n[perm_m]
        off_l, _ = K.out_offsets(counts_l)
        off_m, _ = K.out_offsets(counts_m)

        # staging layout (int32 words), one region a shard:
        #   [payload cat | u3 (S,384) | v (S,384) | lit states (S,4) |
        #    lmd states (S,3) | rows (len(_ROWS), S)]
        spans = {"u3": S * 384, "v": S * 384, "lit_states": S * 4,
                 "lmd_states": S * 3, "rows": len(_ROWS) * S}
        regions, o = [], 0
        for k in range(n_sh):
            at = {"cat": (o, o + int(n_cat[k]))}
            o += int(n_cat[k])
            for key, n in spans.items():
                at[key] = (o, o + n)
                o += n
            regions.append(at)
        if o >= 2**31:
            raise ValueError("batch too large for int32 word offsets")
        stage = self._staging(o)
        host = stage.numpy()

        def views(key, shape):
            return [host[slice(*at[key])].reshape(shape) for at in regions]

        def scatter(shards, slots, values):
            """Write ``values`` at the batch slots ``slots``: slot k * S + j
            is row j of shard k's array ``shards[k]``."""
            for k, view in enumerate(shards):
                here = slots // S == k
                view[slots[here] - k * S] = values[here]

        u3s, vs = views("u3", (S, 384)), views("v", (S, 384))
        if n_sh == 1:
            u3, v = u3s[0], vs[0]
        else:
            u3 = np.empty((B, 384), np.int32)
            v = np.empty((B, 384), np.int32)
        self._native.build_tables3_batch(
            np.ascontiguousarray(w16), sm_n, sl_n, v, u3,
            np.empty(nb, np.int32))
        if n_sh > 1:
            for k in range(n_sh):
                u3s[k][:] = u3[k * S:(k + 1) * S]
                vs[k][:] = v[k * S:(k + 1) * S]
        clock.mark("prep_tables")
        clock.begin("prep_gather")
        base = np.array([at["cat"][0] for at in regions], np.int64)[shard]
        self._native.gather_payloads(
            sources, desc, (base[:nb] + start[:nb]) * 4,
            (base[nb:] + start[nb:]) * 4, host.view(np.uint8), ptrs)
        clock.mark("prep_gather")
        clock.begin("prep_small")
        scatter(views("lit_states", (S, 4)), sl_n, desc[:, 9:13])
        scatter(views("lmd_states", (S, 3)), sm_n, desc[:, 13:16]
                + (0, C.L_STATES, C.L_STATES + C.M_STATES))
        rows = views("rows", (len(_ROWS), S))
        for k, r in enumerate(rows):
            r[:] = 0   # inert slots decode nothing
            r[_ROWS.index("lit_out")] = off_l[k * S:(k + 1) * S] - off_l[k * S]
            r[_ROWS.index("lmd_out")] = off_m[k * S:(k + 1) * S] - off_m[k * S]
        for key, slots, values in (
                ("lit_pos", sl_n, lens_l * 8 - desc[:, 3]),
                ("lmd_pos", sm_n, lens_m * 8 - desc[:, 4]),
                ("lit_num", sl_n, lit_n), ("lmd_num", sm_n, lmd_n),
                ("lit_off", sl_n, start[:nb]), ("lmd_off", sm_n, start[nb:]),
                ("lit_len", sl_n, chunks[:nb] * _W),
                ("lmd_len", sm_n, chunks[nb:] * _W),
                # literal latch thresholds: the U-weight totals
                ("tot", sl_n, w16[:, C.D_TOP:C.U_TOP].sum(axis=1,
                                                         dtype=np.int64))):
            scatter([r[_ROWS.index(key)] for r in rows], slots, values)
        clock.mark("prep_small")
        clock.begin("prep_upload")

        lit, lmd, upload = [], [], []
        for k, (dev, at) in enumerate(zip(self._mesh.devices, regions)):
            a, b = at["cat"][0], at["rows"][1]
            ev = None
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    d = stage[a:b].to(dev, non_blocking=True)
                    ev[1].record()
                self._stage_free.append(ev[1])
            else:
                d = stage[a:b].to(dev)
            upload.append(ev)

            def dview(key, shape):
                x, y = at[key]
                return d[x - a:y - a].view(shape)

            words = dview("cat", (-1,))
            drows = dict(zip(_ROWS, dview("rows", (len(_ROWS), S))))
            n_out_l = int(counts_l[k * S:(k + 1) * S].sum())
            n_out_m = int(counts_m[k * S:(k + 1) * S].sum())
            lit.append(dict(tables=dview("u3", (S, 384)), words=words,
                            word_off=drows["lit_off"],
                            word_len=drows["lit_len"],
                            states=dview("lit_states", (S, 4)),
                            pos=drows["lit_pos"], num=drows["lit_num"],
                            tot=drows["tot"], out_off=drows["lit_out"],
                            n_out=n_out_l))
            lmd.append(dict(tables=dview("v", (S, 384)), words=words,
                            word_off=drows["lmd_off"],
                            word_len=drows["lmd_len"],
                            states=dview("lmd_states", (S, 3)),
                            pos=drows["lmd_pos"], num=drows["lmd_num"],
                            out_off=drows["lmd_out"], n_out=n_out_m))
        clock.mark("prep_upload")
        return _Batch(lit, lmd, sl_n, sm_n,
                      (off_m[sm_n].astype(np.int64), lmd_n),
                      (off_l[sl_n].astype(np.int64) * 4, lit_n),
                      upload=upload if self.device.type == "cuda" else None)

    def _launch(self, batch: _Batch):
        """The kernels' device half: both kernels on every shard
        (``parallel/mesh.launch_decode``). Returns what ``_fse`` returns,
        with each shard's CUDA events before and after its kernels (None on
        the CPU)."""
        return launch_decode(self._mesh, list(zip(batch.lit, batch.lmd)),
                             self._side)

    # -- the FSE stage: the scans (use_kernels=False) -------------------

    def _scan_prep(self, sources, ptrs, desc, w16, clock: _Clock) -> _Batch:
        """The scans' host half: every block's two payloads gathered by one
        ``native.gather_payloads`` call into the zeroed rows of one buffer
        (a row a block, the batch's longest payload and 8 bytes more,
        rounded up to the gather's 512-byte chunks, which it pads with
        zeros), uploaded with the weights and each stream's initial states,
        bit position and count. The scans' outputs are in block order,
        block g's rows at g * n_m and its literals at g * n_l words."""
        clock.begin("prep")
        nb = len(desc)
        lit_n = desc[:, 1].astype(np.int64)
        lmd_n = desc[:, 2].astype(np.int64)
        lens_l = desc[:, 6].astype(np.int64)
        lens_m = desc[:, 8].astype(np.int64)
        w_l = _round_up(int(lens_l.max()) + 8, _ALIGN)
        w_m = _round_up(int(lens_m.max()) + 8, _ALIGN)
        pay = np.zeros(nb * (w_l + w_m), np.uint8)
        g = np.arange(nb, dtype=np.int64)
        self._native.gather_payloads(sources, desc, g * w_l,
                                     nb * w_l + g * w_m, pay, ptrs)

        def up(x, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(
                self.device)

        # the scans run the batch's largest step count, not the format's cap
        n_l = int(K.literal_counts(lit_n).max())
        n_m = int(lmd_n.max())
        lit = dict(payload=up(pay[:nb * w_l].reshape(nb, w_l), np.uint8),
                   states=up(desc[:, 9:13]), pos=up(lens_l * 8 - desc[:, 3]),
                   num=up(lit_n), n_steps=n_l)
        lmd = dict(payload=up(pay[nb * w_l:].reshape(nb, w_m), np.uint8),
                   states=up(desc[:, 13:16]
                             + (0, C.L_STATES, C.L_STATES + C.M_STATES)),
                   pos=up(lens_m * 8 - desc[:, 4]), num=up(lmd_n),
                   n_steps=n_m)
        weights = up(w16)
        clock.mark("prep")
        return _Batch([lit], [lmd], g, g, (g * n_m, lmd_n),
                      (g * n_l * 4, lit_n), weights)

    def _scans(self, batch: _Batch):
        """The scans' device half: the decode tables and both stream scans
        as torch ops on the decoder's device. Returns what ``_fse``
        returns, one shard without events."""
        v_packed, v_base, u_packed = TB.build_decode_tables(batch.weights)
        [lit], [lmd] = batch.lit, batch.lmd
        lits, lit_fs, lit_fp = FD.decode_literals_batch(
            u_packed, FD.bytes_to_windows(lit["payload"]), lit["states"],
            lit["pos"], lit["num"], lit["n_steps"])
        lmds, lmd_fs, lmd_fp = FD.decode_lmds_batch(
            v_packed, v_base, FD.bytes_to_windows(lmd["payload"]),
            lmd["states"], lmd["pos"], lmd["num"], lmd["n_steps"])
        lm = lmds[:, :, 0] | (lmds[:, :, 1] << 16)
        return [((lits.reshape(-1).view(torch.int32), lit_fs, lit_fp,
                  lm.reshape(-1), lmds[:, :, 2].reshape(-1), lmd_fs, lmd_fp),
                 None)]

    # -- the FSE stage's contract ----------------------------------------

    def _fse(self, batch: _Batch):
        """The FSE stage's device half. Returns per shard its outputs on its
        device (literal words, literal states, literal positions, ``lm``,
        ``d`` raw with its repeat zeros, L/M/D states, L/M/D positions;
        ``batch`` says where each block's lie) and the kernels' CUDA events
        (None off a card and for the scans). A batch without an FSE block
        gives one shard of empty outputs."""
        if not batch.lit:
            def z(*shape):
                return torch.zeros(shape, dtype=torch.int32,
                                   device=self.device)
            return [((z(0), z(0, 4), z(0), z(0), z(0), z(0, 3), z(0)), None)]
        return self._fse_run(batch)

    # -- the native rebuild (use_native_rebuild=True) -------------------

    def _back(self, sources, results, frame, launched, stats,
              clock: _Clock):
        """The FSE stage's outputs back into one pinned buffer (each
        output's shards concatenated in batch order), the stream checks,
        then the flatten and ``native.flatten_rebuild``."""
        batch, parts, cpo, cont_nraw, cont_ok, ptrs = frame
        cuda = self.device.type == "cuda"
        # lit, lit_fs, lit_fp, lm, d, lmd_fs, lmd_fp
        self._down, pieces = download_groups(
            list(zip(*(outs for outs, _ in launched))), self._down, cuda)
        if cuda:
            ends = {}
            for dev in self._mesh.devices:
                if dev not in ends:
                    ends[dev] = torch.cuda.Event(enable_timing=True)
                    ends[dev].record(torch.cuda.current_stream(dev))
            for ev in ends.values():
                ev.synchronize()
            if launched[0][1] is not None:   # the kernels' events
                _add_device_ms(stats, self._mesh.devices, batch.upload,
                               [ev for _, ev in launched], ends,
                               self.mesh is not None)
        lit, lit_fs, lit_fp, lm, d, lmd_fs, lmd_fp = pieces
        sl, sm = batch.sl_n, batch.sm_n
        fse_ok = _stream_ok(lit_fs[sl], lit_fp[sl], lmd_fs[sm], lmd_fp[sm])
        clock.mark("device")
        clock.begin("flatten")
        kept, failed, parts_np, cont_off_np, out_offs_np = _flatten_plan(
            parts, cpo, cont_nraw, cont_ok, fse_ok, batch.rows[0],
            batch.lits[0])
        for ci in failed.tolist():
            results[ci] = _spec(sources, ci, stats)
        # rebuild straight into each container's final bytes object
        n_raw = np.diff(out_offs_np)
        out_bytes, out_ptrs = self._native.new_outputs(n_raw)
        clock.mark("flatten")
        clock.begin("rebuild")
        status = self._native.flatten_rebuild(
            lm, d, lit.view(np.uint8), parts_np, cont_off_np, out_offs_np,
            out_ptrs, ptrs)
        good = status == n_raw
        if len(kept) == len(results) and good.all():
            results[:] = out_bytes   # every container, in order
        else:
            _put(results, kept[good], compress(out_bytes, good.tolist()))
        for ci in kept[~good].tolist():
            results[ci] = _spec(sources, ci, stats)
        clock.mark("rebuild")
        return results

    # -- the device rebuild (use_native_rebuild=False) ------------------

    def _dense(self, batch: _Batch, launched):
        """The FSE stage's outputs as the device flatten takes them:
        (dense, states, events), the decoded rows and literals on the
        device with each block's row offset and count and literal byte
        offset and count, the final stream states and positions gathered
        into block order, and the kernels' CUDA events (None off a card
        and for the scans)."""
        # one shard: only the native rebuild takes a mesh
        [((lit, lit_fs, lit_fp, lm, d, lmd_fs, lmd_fp), ev)] = launched
        sl = torch.from_numpy(batch.sl_n).to(self.device).long()
        sm = torch.from_numpy(batch.sm_n).to(self.device).long()
        return ((lm, d, lit.view(torch.uint8), batch.rows, batch.lits),
                (lit_fs[sl], lit_fp[sl], lmd_fs[sm], lmd_fp[sm]), ev)

    def _flat_args(self, dense, conts: list, n_raw):
        """Flatten the containers' parts ``conts`` on the device
        (``ops/lz_rebuild.py`` ``flatten_pieces``). Returns (the
        ``lz_rebuild`` keyword arguments, the plan, the literals each piece
        consumes (device), the output offsets (host))."""
        lm, d, lit_bytes, block_rows, block_lits = dense
        plan = LR.plan_pieces(conts, block_rows, block_lits, lm.numel(),
                              lit_bytes.numel())
        flat = LR.flatten_pieces(lm, d, lit_bytes, plan)
        consumed = flat.pop("consumed")
        out_off = np.concatenate(([0], np.cumsum(np.asarray(n_raw, np.int64))))
        n_out = int(out_off[-1])
        if n_out >= 2**31:
            raise ValueError(f"{n_out} output bytes exceed int32 offsets")

        def t(x):
            return torch.from_numpy(np.asarray(x, np.int32)).to(self.device)

        flat.update(n_raw=t(n_raw), out_off=t(out_off), n_out=n_out)
        return flat, plan, consumed, out_off

    def _rebuild_on_device(self, sources, results, ids, conts, n_raw, dense,
                           states, stats, clock: _Clock):
        """Flatten containers ``ids`` (parts ``conts``, sizes ``n_raw``) and
        rebuild them on the device, then download the final stream
        ``states`` with the rebuild's checks, then the outputs of the
        containers that passed, each into its bytes object. A container
        fails when a block's stream check fails, a block's rows consume more
        literals than it holds, or the rebuild's ``ok`` is false: the spec
        layer decodes it and it counts one fallback."""
        cuda = self.device.type == "cuda"
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(5)]
              if cuda else None)
        if cuda:
            ev[0].record()
        flat, plan, consumed, out_off = self._flat_args(dense, conts, n_raw)
        clock.mark("flatten")
        clock.begin("rebuild")
        if cuda:
            ev[1].record()
        out, ok = CR.lz_rebuild(**flat)
        if cuda:
            ev[2].record()
        self._down, host = download([*states, consumed.int(), ok.int()],
                                    self._down, cuda)
        if cuda:
            ev[3].record()
            ev[3].synchronize()
        lit_fs, lit_fp, lmd_fs, lmd_fp, used, ok_h = host
        fse = plan.kind == 0
        bad = (used[fse] > plan.lit_cap[fse]) | ~_stream_ok(
            lit_fs, lit_fp, lmd_fs, lmd_fp)[plan.block[fse]]
        good = ok_h.astype(bool)
        good[np.repeat(np.arange(len(ids)), np.diff(plan.cont_piece_off))
             [fse][bad]] = False
        keep = np.flatnonzero(good)
        spans = [(int(out_off[k]), int(out_off[k + 1])) for k in keep]
        if cuda:
            # one pinned copy of the whole output, then host threads copy
            # each container's bytes into its own bytes object
            n = out.numel()
            if self._out_pin is None or self._out_pin.numel() < n:
                self._out_pin = torch.empty(_round_up(max(n, 1), 8 << 20),
                                            dtype=torch.uint8,
                                            pin_memory=True)
            self._out_pin[:n].copy_(out, non_blocking=True)
            ev[4].record()
            ev[4].synchronize()
            _add_ms(stats, (("flatten_ms", ev[0], ev[1]),
                            ("rebuild_ms", ev[1], ev[2]),
                            ("download_ms", ev[2], ev[3]),
                            ("out_download_ms", ev[3], ev[4])))
            clock.mark("rebuild")
            clock.begin("out_copy")
            if self._pool is None:
                self._pool = ThreadPoolExecutor(8)
            outs = copy_segments(self._out_pin.data_ptr(), spans, self._pool)
        else:
            outs = [out[a:b].numpy().tobytes() for a, b in spans]
            clock.mark("rebuild")
            clock.begin("out_copy")
        for k, res in zip(keep, outs):
            results[ids[k]] = res
        clock.mark("out_copy")
        clock.begin("rebuild")
        for k in np.flatnonzero(~good):
            results[ids[k]] = _spec(sources, ids[k], stats)
        clock.mark("rebuild")
        return results

    def _back_device(self, sources, results, frame, launched, stats,
                     clock: _Clock):
        """The flatten and the LZ rebuild on the device: the FSE stage's
        outputs never come back to the host."""
        batch, parts, cpo, cont_nraw, cont_ok, _ = frame
        dense, states, ev = self._dense(batch, launched)
        clock.mark("device")
        clock.begin("flatten")
        ids, conts = [], []
        for ci in np.flatnonzero(cont_ok).tolist():
            try:
                conts.append(_walk_parts(sources[ci],
                                         parts[cpo[ci]:cpo[ci + 1]]))
            except LzfseError:   # a malformed LZVN payload
                results[ci] = _spec(sources, ci, stats)
                continue
            ids.append(ci)
        self._rebuild_on_device(sources, results, ids, conts, cont_nraw[ids],
                                dense, states, stats, clock)
        if ev is not None:
            _add_ms(stats, (("upload_ms", *batch.upload[0]),
                            ("kernels_ms", ev[0], ev[1])))
        return results

    # -- public ----------------------------------------------------------

    def decode_many(self, sources: list[bytes],
                    stats: dict | None = None) -> list[bytes]:
        """Decode a batch of containers, block-parallel across all of them.

        ``stats``, when given, receives wall-clock seconds per stage
        (``parse``, ``prep``, ``device``, ``flatten``, ``rebuild``; with
        the device rebuild also ``out_copy``), the prep sub-stages under
        ``detail_prep`` (the kernels), the calling thread's CPU seconds in
        each of those stages under ``detail_cpu`` (``{"user": s, "sys":
        s}`` under the same keys, the prep split under its
        ``detail_prep``; see ``_Clock``), on a card the CUDA-event
        milliseconds under ``detail_device`` (the upload, the kernels and
        the download, with a mesh each the longest over its devices, and
        each shard's kernels under ``shard_kernels_ms``; with the device
        rebuild also the flatten, the rebuild and the output bytes'
        download, ``out_download_ms``), and the count of spec-layer
        ``fallbacks``. ``detail_parts`` counts what the container walk
        found: ``containers`` (the sources), ``host_only`` (accepted
        containers whose output the device takes no part in on this call's
        path: with the native rebuild those with no FSE block, whose LZVN
        and RAW blocks are decoded on host threads; with the device rebuild
        only those with no block at all), their raw bytes
        ``host_only_bytes``, the raw bytes of every accepted container
        ``raw_bytes``, and the blocks of each kind, ``fse_blocks``,
        ``vn_blocks`` and ``raw_blocks``; ``walks`` the tries of the native
        walk (one where the batch fits the last call's capacity). Every
        count and every second adds to what ``stats`` already holds. Under an active
        ``torch.profiler`` session the call is a ``lzfse.decode_many``
        range with a ``lzfse.decode.<stage>`` range a stage inside it
        (``lzfse.decode.prep.tables`` for ``prep_tables``). Not
        re-entrant: the staging buffers belong to the decoder."""
        with _Clock(stats, "decode") as clock:
            results, frame = self._front(sources, stats, clock)
            clock.fold("prep")
            clock.begin("device")
            launched = self._fse(frame[0])
            return self._rebuild(sources, results, frame, launched, stats,
                                 clock)

    def decode_bytes(self, src: bytes) -> bytes:
        """Decode one container: ``decode_many([src])[0]``."""
        return self.decode_many([src])[0]

    def kernel_args(self, sources: list[bytes]) -> tuple[dict, dict]:
        """The two kernels' arguments for a batch, on this decoder's device:
        ``(decode_literals kwargs, decode_lmds kwargs)``, as
        ``decode_many`` passes them (a decoder without a mesh; with
        ``use_kernels=False`` the scans' inputs)."""
        if self.mesh is not None:
            raise ValueError("kernel_args: a mesh decoder has a pair of "
                             "arguments per shard")
        _, (batch, *_rest) = self._front(sources, None, _Clock(None))
        if not batch.lit:
            raise ValueError("the batch holds no FSE block")
        return batch.lit[0], batch.lmd[0]

    def flatten_inputs(self, sources: list[bytes]):
        """What the device flatten of ``decode_many`` with
        ``use_native_rebuild=False`` takes, for every container the walk
        accepts: (dense, parts, sizes), the FSE stage's outputs on this
        decoder's device with the blocks' offsets and counts, each
        container's flatten parts, and their sizes (``_flat_args``'s
        arguments)."""
        _, (batch, parts, cpo, cont_nraw, cont_ok, _) = self._front(
            sources, None, _Clock(None))
        dense, _, _ = self._dense(batch, self._fse(batch))
        ids = np.flatnonzero(cont_ok).tolist()
        conts = [_walk_parts(sources[ci], parts[cpo[ci]:cpo[ci + 1]])
                 for ci in ids]
        return dense, conts, cont_nraw[ids]

    def rebuild_args(self, sources: list[bytes]) -> dict:
        """The LZ rebuild's arguments for a batch, on this decoder's device:
        the ``ops/cuda_rebuild.py`` ``lz_rebuild`` keyword arguments that
        ``decode_many`` with ``use_native_rebuild=False`` builds (the FSE
        stage's decoded rows, flattened on the device), for every container
        the walk accepts."""
        return self._flat_args(*self.flatten_inputs(sources))[0]
