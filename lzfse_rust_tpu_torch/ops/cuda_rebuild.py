"""The LZ rebuild as a CUDA kernel: wrapper, plain version, and the adapter
that carries the JAX function's arguments across.

Counterpart of ``lzfse_rust_tpu/ops/lz_rebuild.py`` ``lz_rebuild_batch``.
The kernel (``csrc/lz_rebuild.cu``) takes the flat, ragged layout of
``ops/lz_rebuild.py`` ``lz_rebuild_flat``, its plain version: container
c's literal pool ``literals[lit_off[c]:lit_off[c+1]]`` (uint8), rows
``rows[row_off[c]:row_off[c+1]]`` ((R, 3) int32 (l, m, d), d substituted),
true size ``n_raw[c]`` and output segment ``out[out_off[c]:out_off[c+1]]``;
offsets int32 (B + 1,) from 0. It returns (out (n_out,) uint8, ok (B,)
bool).

On a CUDA device the wrapper launches the kernel or raises; only for CPU
tensors does it run the plain version. ``launches`` counts kernel launches
(one per call that has work).
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import numpy as np
import torch

from ..runtime import cuda_lib
from . import lz_rebuild as LR
from .cuda_decode import source_constant

launches = {"lz_rebuild": 0}

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "lz_rebuild.cu"
# output positions per lzr_tile block, as the source sets it
TILE = source_constant(SOURCE, re.compile(r"^constexpr int kTile = (\d+);",
                                          re.M), "kTile")

lz_rebuild_ref = LR.lz_rebuild_flat


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(literals, lit_off, rows, row_off, n_raw, out_off) -> torch.device:
    """Validate dtype, contiguity, device and shape; return the device."""
    dev = rows.device
    B = n_raw.numel()
    want = {"lit_off": (B + 1,), "row_off": (B + 1,), "n_raw": (B,),
            "out_off": (B + 1,)}
    if literals.dtype != torch.uint8 or literals.dim() != 1:
        raise TypeError("lz_rebuild: literals must be 1-D uint8")
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 3:
        raise TypeError(f"lz_rebuild: rows must be (R, 3) int32, got "
                        f"{tuple(rows.shape)} {rows.dtype}")
    for key, t in dict(literals=literals, lit_off=lit_off, rows=rows,
                       row_off=row_off, n_raw=n_raw, out_off=out_off).items():
        if key in want:
            if t.dtype != torch.int32:
                raise TypeError(f"lz_rebuild: {key} must be int32, got "
                                f"{t.dtype}")
            if tuple(t.shape) != want[key]:
                raise ValueError(f"lz_rebuild: {key} must be {want[key]}, "
                                 f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"lz_rebuild: {key} must be contiguous")
        if t.device != dev:
            raise ValueError(f"lz_rebuild: {key} is on {t.device}, rows on "
                             f"{dev}")
    return dev


def lz_rebuild(literals, lit_off, rows, row_off, n_raw, out_off,
               n_out: int | None = None, detail: dict | None = None):
    """Rebuild every container's output (see the module docstring).
    ``n_out`` is ``out_off[-1]``: pass it to spare a device-to-host read.
    With ``detail``, ``detail["unresolved"]`` is set to the positions still
    pointing at a parent after the tiles, then after each doubling round
    that had work (a device-to-host read). Raises ``ValueError`` when the output,
    the rows or the literals reach 2**31 entries (the kernel's indices are
    int32)."""
    dev = _check(literals, lit_off, rows, row_off, n_raw, out_off)
    B = n_raw.numel()
    if n_out is None:
        n_out = int(out_off[-1]) if B else 0
    for what, n in (("output positions", n_out), ("rows", rows.shape[0]),
                    ("literals", literals.numel())):
        if n >= 2**31:
            raise ValueError(f"lz_rebuild: {n} {what} reach 2**31, beyond "
                             f"int32 offsets")
    if dev.type == "cpu":
        return lz_rebuild_ref(literals, lit_off, rows, row_off, n_raw,
                              out_off, n_out, detail)
    if dev.type != "cuda":
        raise ValueError(f"lz_rebuild: no kernel for device {dev}")
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        if detail is not None:
            detail["unresolved"] = []
        return out, ok
    span_end, lit_end, row_start = LR.row_prefix(rows, row_off, out_off)
    # enough rounds for any segment: k rounds resolve 2**k links
    rounds = max(int(n_out - 1).bit_length(), 1)
    n = max(n_out, 1)
    root = torch.empty(n, dtype=torch.int32, device=dev)
    tile_open = torch.empty(2 * -(-n // TILE), dtype=torch.int32, device=dev)
    counts = torch.zeros(rounds + 1, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (literals, lit_off, rows, row_off, n_raw,
                                   out_off, span_end, lit_end, row_start,
                                   root, tile_open, counts, out, ok)]
    with torch.cuda.device(dev):
        rc = cuda_lib.lib().lzt_lz_rebuild(
            *ptrs, B, rows.shape[0], n_out, literals.numel(), rounds,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "lz_rebuild")
    launches["lz_rebuild"] += 1
    if detail is not None:
        counts = counts.tolist()
        while len(counts) > 1 and counts[-1] == counts[-2] == 0:
            counts.pop()
        detail["unresolved"] = counts
    return out, ok


def kernel_attrs() -> dict:
    """Registers, local (spill) bytes per thread and resident CUDA blocks
    per SM of the rebuild's three main kernels, as the loaded library
    reports them (needs a card)."""
    out = {}
    for k, name in enumerate(("lzr_tile", "lzr_round", "lzr_out")):
        a = (ctypes.c_int * 3)()
        cuda_lib.check(cuda_lib.lib().lzt_lz_rebuild_attrs(k, a),
                       "lz_rebuild_attrs")
        out[name] = {"registers": a[0], "local_bytes": a[1],
                     "blocks_per_sm": a[2]}
    return out


def from_jax_rebuild_args(literals, rows, n_raw, n_out: int,
                          device="cpu") -> dict:
    """Keyword arguments of ``lz_rebuild`` from the numpy arguments of the
    JAX ``lz_rebuild_batch``: literals (B, L) uint8, rows (B, R, 3) int32,
    n_raw (B,), n_out. Container b's pool is the whole padded row b of
    ``literals`` (JAX's L), its rows the R padded rows, its segment n_out
    positions, so ``out.reshape(B, n_out)`` and ``ok`` are the JAX
    function's."""
    lits = np.ascontiguousarray(literals, np.uint8)
    rws = np.ascontiguousarray(rows, np.int32)
    B, L = lits.shape
    R = rws.shape[1]

    def t(x, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return dict(literals=t(lits.reshape(-1), np.uint8),
                lit_off=t(np.arange(B + 1) * L), rows=t(rws.reshape(-1, 3)),
                row_off=t(np.arange(B + 1) * R), n_raw=t(n_raw),
                out_off=t(np.arange(B + 1) * n_out), n_out=B * n_out)
