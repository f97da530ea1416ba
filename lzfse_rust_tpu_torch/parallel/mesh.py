"""Several devices: data-parallel sharding of the block or window batch.

Counterpart of ``lzfse_rust_tpu/parallel/mesh.py``, under the same names.
An LZFSE container is a run of independent blocks, and the device
frontend's windows each carry their own history, so the batch splits along
its leading axis into contiguous, equal shards (JAX's ``P(axis)``): each
device runs the same stage on its shard, and an ordered gather puts the
results back in batch order. Nothing crosses between shards before the
gather.

Where JAX writes sharding annotations and lets XLA place the work, the port
does it by hand: every shard's inputs go to its device, each stage is
enqueued on every device before anything is read back (so the devices run
at once), and the results are copied to the mesh's first device and
concatenated there. Across processes, ``gather_compressed`` goes through
``torch.distributed`` (gloo on the CPU, NCCL on cards).

A shard runs exactly what the unsharded call runs on its rows, kernel for
kernel: the four CUDA kernels of the serving paths (the decode pair,
``lz_rebuild`` and ``match_grouped``) on a card, their plain versions for
CPU tensors. Nothing falls back: a shard whose kernel fails raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..base import constants as C
from ..ops import cuda_decode as K
from ..ops import cuda_rebuild as CR
from ..ops import fse_decode as FD
from ..ops import lz_rebuild as LR
from ..ops import match_find as MF
from ..ops import table_build as TB


@dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh of devices along one named batch axis.

    A device may appear more than once (``["cuda:0"] * 4``, ``["cpu"] *
    4``): one card, or the CPU, then stands in for several, as the virtual
    CPU devices do for JAX's tests. That is a test facility; on one card
    the shards take turns."""
    devices: tuple
    axis: str = "blocks"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "blocks") -> Mesh:
    """A 1-D data-parallel mesh over the given devices (names, indices or
    ``torch.device``s), or over every CUDA device when ``devices`` is
    None."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices, "
                               "e.g. make_mesh(['cpu'] * 4)")
        devices = range(torch.cuda.device_count())
    devs = tuple(torch.device("cuda", d) if isinstance(d, int)
                 else torch.device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs, axis)


def _bounds(mesh: Mesh, n: int, axis: str, what: str) -> list:
    """The (start, stop) of each device's contiguous, equal shard of ``n``
    rows; raises ``ValueError`` unless ``n`` divides by the mesh size."""
    if axis != mesh.axis:
        raise ValueError(f"{what}: the mesh's axis is {mesh.axis!r}, not "
                         f"{axis!r}")
    if n % mesh.size:
        raise ValueError(f"{what}: a batch of {n} does not divide into "
                         f"{mesh.size} equal shards")
    s = n // mesh.size
    return [(k * s, (k + 1) * s) for k in range(mesh.size)]


def _host(x) -> torch.Tensor:
    """A tensor of ``x`` (numpy array, sequence or tensor), copying nothing
    that is a tensor already."""
    if torch.is_tensor(x):
        return x
    a = np.ascontiguousarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _put(x, a: int, b: int, dev) -> torch.Tensor:
    """Rows ``a:b`` of ``x``, contiguous, on ``dev`` (a ``non_blocking``
    copy from pinned host memory)."""
    return _host(x)[a:b].contiguous().to(dev, non_blocking=True)


def shard_batch(mesh: Mesh, axis: str = "blocks"):
    """The split of a leading batch axis over ``mesh``: returns ``put(x)``,
    which gives each device its contiguous, equal shard of ``x`` (rows in
    batch order), on that device. ``put`` raises ``ValueError`` unless the
    batch divides by the mesh size."""
    def put(x) -> list:
        x = _host(x)
        return [_put(x, a, b, dev) for dev, (a, b) in
                zip(mesh.devices, _bounds(mesh, x.shape[0], axis,
                                          "shard_batch"))]
    return put


def _gather(mesh: Mesh, parts) -> torch.Tensor:
    """The shards' results concatenated in batch order on the first
    device."""
    dev = mesh.devices[0]
    return torch.cat([p.to(dev) for p in parts])


def _gather_all(mesh: Mesh, per_shard) -> tuple:
    """``_gather`` of each output of the shards' result tuples."""
    return tuple(_gather(mesh, col) for col in zip(*per_shard))


# --- the portable pipeline -----------------------------------------------------

def _entropy_pipeline(weights, lit_payload, lmd_payload, lit_states, lit_pos,
                      lit_num, lmd_states, lmd_pos, lmd_num,
                      n_lit_steps: int, n_lmd_steps: int):
    """One shard's entropy decode as torch ops on its device: the decode
    tables, both stream scans, the repeat distances resolved and each
    block's stream check. Returns (literals (B, 4 * n_lit_steps) uint8,
    lmds (B, n_lmd_steps, 3) int32, ok (B,) bool)."""
    v_packed, v_base, u_packed = TB.build_decode_tables(weights)
    literals, lit_fs, lit_fp = FD.decode_literals_batch(
        u_packed, FD.bytes_to_windows(lit_payload), lit_states, lit_pos,
        lit_num, n_lit_steps)
    lmds, lmd_fs, lmd_fp = FD.decode_lmds_batch(
        v_packed, v_base, FD.bytes_to_windows(lmd_payload), lmd_states,
        lmd_pos, lmd_num, n_lmd_steps)
    lmds[:, :, 2] = LR.substitute_distances(lmds[:, :, 2])
    ok = ((lit_fs == 0).all(dim=1) & (lit_fp >= 64)
          & (lmd_fs[:, 0] == 0) & (lmd_fs[:, 1] == C.L_STATES)
          & (lmd_fs[:, 2] == C.L_STATES + C.M_STATES) & (lmd_fp >= 64))
    return literals, lmds, ok


_PIPELINE_KEYS = ("weights", "lit_payload", "lmd_payload", "lit_states",
                  "lit_pos", "lit_num", "lmd_states", "lmd_pos", "lmd_num")


def sharded_entropy_decode(mesh: Mesh, arrays: dict, n_lit_steps: int,
                           n_lmd_steps: int, axis: str = "blocks"):
    """``_entropy_pipeline`` with the block batch sharded over ``mesh``.
    ``arrays`` holds the host arrays of its arguments, batch-leading (the
    JAX decoder's portable layout); the batch must divide by the mesh
    size. Returns its outputs gathered on the first device."""
    B = _host(arrays["weights"]).shape[0]
    bounds = _bounds(mesh, B, axis, "sharded_entropy_decode")
    outs = [_entropy_pipeline(*(_put(arrays[k], a, b, dev)
                                for k in _PIPELINE_KEYS),
                              n_lit_steps=n_lit_steps,
                              n_lmd_steps=n_lmd_steps)
            for dev, (a, b) in zip(mesh.devices, bounds)]
    return _gather_all(mesh, outs)


def sharded_rebuild(mesh: Mesh, literals, rows, n_raw, n_out: int,
                    axis: str = "blocks"):
    """Container-parallel LZ rebuild: each device rebuilds its shard of
    containers with ``ops/cuda_rebuild.lz_rebuild`` (the CUDA kernel on a
    card; its plain version, ``lz_rebuild_flat``, on the CPU). Arguments
    and results as the JAX ``lz_rebuild_batch``'s: literals (B, L) uint8,
    rows (B, R, 3) int32, n_raw (B,), n_out; (out (B, n_out) uint8, ok (B,)
    bool) on the first device."""
    lits = np.asarray(_host(literals).cpu())
    rws = np.asarray(_host(rows).cpu())
    nraw = np.asarray(_host(n_raw).cpu())
    bounds = _bounds(mesh, lits.shape[0], axis, "sharded_rebuild")
    outs = []
    for dev, (a, b) in zip(mesh.devices, bounds):
        out, ok = CR.lz_rebuild(**CR.from_jax_rebuild_args(
            lits[a:b], rws[a:b], nraw[a:b], n_out, device=dev))
        outs.append((out.view(b - a, n_out), ok))
    return _gather_all(mesh, outs)


# --- the decode kernels per shard ----------------------------------------------

def launch_decode(mesh: Mesh, shards: list, side: dict | None = None):
    """Both decode kernels on every shard, each on its device: ``shards[k]``
    is ``(decode_literals kwargs, decode_lmds kwargs)`` on
    ``mesh.devices[k]``. Every shard is enqueued before anything is read,
    so the devices run at once; on a card the L/M/D kernel runs on a
    second stream of its device (``side`` maps each device to it, and is
    filled as devices appear), joined back before anything reads it.
    Returns per shard its outputs (literal words, lit states, lit pos, lm,
    d, lmd states, lmd pos) and, on a card, CUDA events before and after
    its kernels on its device's current stream (else None)."""
    side = {} if side is None else side
    out = []
    for dev, (lit, lmd) in zip(mesh.devices, shards):
        if dev.type != "cuda":
            out.append(((*K.decode_literals(**lit), *K.decode_lmds(**lmd)),
                        None))
            continue
        with torch.cuda.device(dev):
            main = torch.cuda.current_stream(dev)
            if dev not in side:
                side[dev] = torch.cuda.Stream(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(main)
            side[dev].wait_stream(main)
            lit_outs = K.decode_literals(**lit)
            with torch.cuda.stream(side[dev]):
                lmd_outs = K.decode_lmds(**lmd)
            main.wait_stream(side[dev])
            for t in lmd_outs:
                t.record_stream(main)
            ev[1].record(main)
        out.append(((*lit_outs, *lmd_outs), ev))
    return out


def sharded_pallas_entropy_decode(mesh: Mesh, arrays: dict, n_lit_steps: int,
                                  n_lmd_steps: int, axis: str = "blocks",
                                  epoch: int | None = None):
    """The serving decode kernels with the block batch sharded over
    ``mesh``: each device runs ``decode_literals`` and ``decode_lmds``
    (``ops/cuda_decode.py``) on its shard (``launch_decode``).

    ``arrays`` carries the JAX kernels' arguments, batch-leading, under
    their keys: u3_tabs, v_tabs (B, 384), lit_words, lmd_words (B, W)
    int32, lit_states, lit_pos, lit_num, lmd_states, lmd_pos, lmd_num
    (B, 128) int32, lit_tot (B,). Each shard converts its rows with
    ``from_jax_decode_args``, so its word and output offsets start at its
    own first row. A stream decodes at most ``n_lit_steps`` (4 literals a
    step) or ``n_lmd_steps`` steps; the JAX kernels round that cap up to
    whole superepochs, so the two agree wherever the counts lie within the
    steps. ``epoch``, the TPU kernels' superepoch length, is accepted for
    the JAX signature and ignored: the CUDA kernels have no superepochs.

    Returns, in the port's dense layout and gathered on the first device
    (equal to the unsharded kernels' outputs on the same arguments):
    (literal words, lm, d, lit final states (B, 4), lit final positions,
    lmd final states (B, 3), lmd final positions)."""
    del epoch   # a TPU superepoch cap; the CUDA kernels have none
    a_ = {k: np.asarray(_host(arrays[k]).cpu()) for k in (
        "u3_tabs", "v_tabs", "lit_words", "lmd_words", "lit_states",
        "lit_pos", "lit_num", "lit_tot", "lmd_states", "lmd_pos", "lmd_num")}
    bounds = _bounds(mesh, a_["u3_tabs"].shape[0], axis,
                     "sharded_pallas_entropy_decode")
    lit_num = np.minimum(a_["lit_num"], 4 * n_lit_steps)
    lmd_num = np.minimum(a_["lmd_num"], n_lmd_steps)
    shards = []
    for dev, (a, b) in zip(mesh.devices, bounds):
        lit = K.from_jax_decode_args(
            "literals", a_["u3_tabs"][a:b], a_["lit_words"][a:b],
            a_["lit_states"][a:b], a_["lit_pos"][a:b], lit_num[a:b],
            a_["lit_tot"][a:b], device=dev)
        lmd = K.from_jax_decode_args(
            "lmds", a_["v_tabs"][a:b], a_["lmd_words"][a:b],
            a_["lmd_states"][a:b], a_["lmd_pos"][a:b], lmd_num[a:b],
            device=dev)
        shards.append((lit, lmd))
    outs = [o for o, _ in launch_decode(mesh, shards)]
    lit, lfs, lfp, lm, d, mfs, mfp = _gather_all(mesh, outs)
    return lit, lm, d, lfs, lfp, mfs, mfp


# --- the encode frontend per shard ---------------------------------------------

def _match_find_batch(src_pad, n_real, vn: bool):
    """``find_matches_device`` over a batch of windows (W, N), one window
    at a time: (pos (W, N), cands, lcps (W, HASH_WIDTH, N))."""
    W, N = src_pad.shape
    if W == 0:
        z = torch.zeros((0, C.HASH_WIDTH, N), dtype=torch.int32,
                        device=src_pad.device)
        return z[:, 0], z, z.clone()
    outs = [MF.find_matches_device(src_pad[w], n_real[w], vn)
            for w in range(W)]
    return tuple(torch.stack(col) for col in zip(*outs))


def sharded_match_find(mesh: Mesh, windows, n_real, vn: bool = False,
                       axis: str = "blocks"):
    """The sorted match finder (``ops/match_find.find_matches_device``, torch
    ops) with the windows sharded over ``mesh``. windows: (W, N) uint8
    zero-padded; n_real: (W,) int32. Returns the stacked per-window (pos,
    cands, lcps), gathered on the first device."""
    wins = _host(windows)
    nr = _host(n_real)
    bounds = _bounds(mesh, wins.shape[0], axis, "sharded_match_find")
    outs = [_match_find_batch(_put(wins, a, b, dev), _put(nr, a, b, dev), vn)
            for dev, (a, b) in zip(mesh.devices, bounds)]
    return _gather_all(mesh, outs)


def sharded_grouped_match(mesh: Mesh, pads, n_reals, los, his, orders, oks,
                          vn: bool = False, axis: str = "blocks"):
    """The grouped match finder (``ops/match_find.match_rows``: the
    ``match_grouped`` kernel on a card) with the window batch sharded over
    ``mesh``. Arguments as ``match_rows``'s, on the host (pinned memory
    makes the uploads asynchronous); the window count must divide by the
    mesh size (callers pad with inert windows). Every shard is uploaded and
    launched before any shard's totals are read.

    Returns ``match_rows``'s result for the whole batch on the first
    device: ``(offsets (B + 1, 2), matched (M, 2), m_len (M,), sat (S,
    9))``, each shard's rows after the previous shard's. The JAX function
    returns every slot's ``(keys, best_cand, best_len, cands, lcps)``, from
    which the JAX encoder took the key-1 slots' winners and, through
    ``take_sat_cols``, the key-0 slots' columns: ``matched``, ``m_len``
    and ``sat`` are those, window after window, each window's slots in
    ascending order."""
    args = dict(pads=pads, n_reals=n_reals, los=los, his=his, orders=orders,
                oks=oks)
    bounds = _bounds(mesh, _host(pads).shape[0], axis,
                     "sharded_grouped_match")
    launched = [MF.match_rows_launch(**{k: _put(v, a, b, dev)
                                        for k, v in args.items()}, vn=vn)
                for dev, (a, b) in zip(mesh.devices, bounds)]
    done = [MF.match_rows_finish(x) for x in launched]
    dev0 = mesh.devices[0]
    base = torch.zeros(2, dtype=torch.int32, device=dev0)
    offsets = []
    for off, *_ in done:
        off = off.to(dev0)
        offsets.append(off[:-1] + base)
        base = base + off[-1]
    offsets.append(base[None])
    return (torch.cat(offsets), *(_gather(mesh, col)
                                  for col in list(zip(*done))[1:]))


# --- the ordered gather --------------------------------------------------------

def gather_compressed(mesh: Mesh, padded_blocks, lengths, axis: str = "blocks",
                      group=None):
    """Ordered gather of fixed-capacity compressed blocks and their true
    lengths along the batch.

    ``padded_blocks`` (B, cap) and ``lengths`` (B,) are either one
    batch-leading array each (split over the mesh as ``shard_batch`` splits
    it) or one tensor per mesh device, in batch order. Within one process
    the shards are copied to the first device and concatenated there. With
    ``group`` (a ``torch.distributed`` process group, each process holding
    its own shard of the global batch on its own mesh), the process's
    result is then all-gathered across the group in rank order
    (``all_gather_into_tensor``: gloo on the CPU, NCCL on cards), so every
    process gets every block. Returns (blocks, lengths) on the first
    device."""
    def local(x):
        if isinstance(x, (list, tuple)) and len(x) == mesh.size \
                and all(torch.is_tensor(t) for t in x):
            return _gather(mesh, x)
        return _gather(mesh, shard_batch(mesh, axis)(x))

    blocks, lens = local(padded_blocks), local(lengths)
    if group is None:
        return blocks, lens
    import torch.distributed as dist
    world = dist.get_world_size(group)

    def all_gather(t):
        t = t.contiguous()
        out = torch.empty((world * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out

    return all_gather(blocks), all_gather(lens)
