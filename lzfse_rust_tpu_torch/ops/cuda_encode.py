"""Batched tANS stream encode: the CUDA kernels, their plain versions, and
the adapters that carry the JAX kernels' arguments and results across.

Counterpart of ``lzfse_rust_tpu/ops/pallas_encode.py``. The two kernels
(``csrc/fse_encode.cu``) compute what ``encode_literals_pallas`` and
``encode_lmds_pallas`` compute, in the layout that ``native.frontend_stage``
writes and ``native.pack_stage`` reads:

* tables: the packed E entries of ``ops/fse_encode.build_encode_tables``,
  ``e_u`` (B, 256) for literals, ``e_l``/``e_m``/``e_d`` (B, 20/20/64);
* rows (B, n_cols), right-justified (a block's last group or row sits in
  column n_cols-1): ``words`` (4 literal bytes per int32, little-endian),
  or ``lm = l | m << 16`` and ``d`` (0 means a repeat);
* ``num`` (B,): literal count (steps ``(num + 3) >> 2``) or row count
  (steps ``num``), steps capped at n_cols;
* ``order`` (B,): a permutation of the slots; each CUDA block takes
  ``kSlots`` consecutive entries (longest first keeps a block's slots on
  similar step counts). Results do not depend on it.

Outputs: ``glo`` and ``gmeta`` (B, n_cols), column i holding push group i
in forward payload order for i below the row's step count (``gmeta`` is
``hi8 | n << 8`` for literals, ``hi22 | n << 22`` for L/M/D); later columns
are left unwritten by the kernels and are zero in the plain versions
(``defined_columns`` zeroes them for comparisons). Final states (B, 4) or
(B, 3), as raw table states.

All tensors are int32, contiguous, on one device. On a CUDA device the
wrappers launch the kernel or raise; only for CPU tensors do they run the
plain version. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

from ..base import constants as C
from ..runtime import cuda_lib
from .cuda_decode import _pointers, _to_i32, _wrap32, source_constant

# kernel launches per wrapper, for checks that a run went through them
launches = {"encode_literals": 0, "encode_lmds": 0}

_M32 = 0xFFFFFFFF

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "fse_encode.cu"
# the source lines that set both kernels' slots per CUDA block (the one
# tuning constant) and steps per tile
SLOTS_LINE = re.compile(r"^constexpr int kSlots = (\d+);$", re.M)
TILE_LINE = re.compile(r"^constexpr int kTile = (\d+);", re.M)


def slots_per_block(source: str | None = None) -> int:
    """Slots per CUDA block of both encode kernels, as ``fse_encode.cu``
    (or the given source text) sets it; needs no build."""
    return source_constant(SOURCE, SLOTS_LINE, "kSlots", source)


def tile_steps(source: str | None = None) -> int:
    """Steps per tile of both encode kernels (``kTile``)."""
    return source_constant(SOURCE, TILE_LINE, "kTile", source)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def steps_of(kind: str, num, n_cols: int):
    """Steps per row: ``(num + 3) >> 2`` literal groups (kind
    ``"literals"``) or ``num`` L/M/D rows (``"lmds"``), clamped to
    [0, n_cols]. Takes and returns a numpy array or a tensor."""
    n = num.long() if torch.is_tensor(num) else np.asarray(num, np.int64)
    s = (n + 3) >> 2 if kind == "literals" else n
    return s.clip(0, n_cols)


def slot_order(steps) -> np.ndarray:
    """The kernels' ``order``: slots by step count, longest first (stable),
    int32."""
    return np.argsort(-np.asarray(steps, np.int64), kind="stable").astype(
        np.int32)


def _validate(name: str, widths: dict, row_keys: tuple, tensors: dict):
    """Every tensor int32, contiguous, on one device, of its shape: tables
    (B, width), rows (B, n_cols), num and order (B,). Returns (device, B,
    n_cols)."""
    rows = tensors[row_keys[0]]
    if rows.dim() != 2:
        raise ValueError(f"{name}: {row_keys[0]} must be (B, n_cols), got "
                         f"{tuple(rows.shape)}")
    B, n_cols = rows.shape
    shapes = {**{k: (B, w) for k, w in widths.items()},
              **{k: (B, n_cols) for k in row_keys}, "num": (B,),
              "order": (B,)}
    dev = rows.device
    for key, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"{row_keys[0]} on {dev}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {shapes[key]}, got "
                             f"{tuple(t.shape)}")
    return dev, B, n_cols


def _launch(name: str, dev, B: int, n_cols: int, lanes: int, inputs):
    """Allocate the outputs, launch ``lzt_<name>`` on the current stream."""
    glo = torch.empty((B, n_cols), dtype=torch.int32, device=dev)
    gmeta = torch.empty((B, n_cols), dtype=torch.int32, device=dev)
    fs = torch.empty((B, lanes), dtype=torch.int32, device=dev)
    if B and n_cols:
        with torch.cuda.device(dev):
            rc = getattr(cuda_lib.lib(), f"lzt_{name}")(
                *_pointers(*inputs, glo, gmeta, fs), B, n_cols,
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(rc, name)
        launches[name] += 1
    return glo, gmeta, fs


def encode_literals(e_u, words, num, order):
    """Literal encode (4 interleaved states). Returns (glo, gmeta (B,
    n_cols), final states (B, 4)), int32."""
    dev, B, n_cols = _validate(
        "encode_literals", {"e_u": 256}, ("words",),
        dict(e_u=e_u, words=words, num=num, order=order))
    if dev.type == "cpu":
        return encode_literals_ref(e_u, words, num, order)
    if dev.type != "cuda":
        raise ValueError(f"encode_literals: no kernel for device {dev}")
    return _launch("encode_literals", dev, B, n_cols, 4,
                   (e_u, words, num, order))


def encode_lmds(e_l, e_m, e_d, lm, d, num, order):
    """L/M/D encode (3 interleaved states). Returns (glo, gmeta (B,
    n_cols), final states (B, 3)), int32."""
    dev, B, n_cols = _validate(
        "encode_lmds", {"e_l": 20, "e_m": 20, "e_d": 64}, ("lm", "d"),
        dict(e_l=e_l, e_m=e_m, e_d=e_d, lm=lm, d=d, num=num, order=order))
    if dev.type == "cpu":
        return encode_lmds_ref(e_l, e_m, e_d, lm, d, num, order)
    if dev.type != "cuda":
        raise ValueError(f"encode_lmds: no kernel for device {dev}")
    return _launch("encode_lmds", dev, B, n_cols, 3,
                   (e_l, e_m, e_d, lm, d, num, order))


# --- plain versions -----------------------------------------------------------
#
# Vectorised over rows; every lookup is made for all steps up front (it
# depends on the input only), then a Python loop over steps carries the
# states. Everything is int64 and wraps to int32 where JAX's int32 would.

def _e_steps(t_k, t_w, s, steps):
    """Run the states ``s`` (B, L) through ``n`` steps of entries ``t_k``,
    ``t_w`` (B, n, L). Returns (bits, n_b) (B, n, L), zero on inactive
    steps, and the final states."""
    n = t_k.shape[1]
    bits = torch.zeros_like(t_k)
    n_b = torch.zeros_like(t_k)
    for i in range(n):
        active = (i < steps)[:, None]
        nb = (_wrap32(t_k[:, i] + s) >> 10).clamp(0, 25)
        bits[:, i] = torch.where(active, s & ((torch.ones_like(nb) << nb) - 1),
                                 0)
        n_b[:, i] = torch.where(active, nb, 0)
        s = torch.where(active, _wrap32(t_w[:, i] + (s >> nb)), s)
    return bits, n_b, s


def _groups(pairs, n, shift: int):
    """Pairs (B, steps, L) with bit counts n, lane 0 at bit 0 and each next
    lane above the ones before it, into (lo, hi | total << shift)."""
    sh = n.cumsum(-1) - n
    group = torch.zeros_like(pairs[..., 0])
    for lane in range(pairs.shape[-1]):
        at = sh[..., lane]
        group |= torch.where(at < 64, (pairs[..., lane] & _M32)
                             << at.clamp(max=63), 0)
    hi = (group >> 32) & _M32
    return group & _M32, hi | (n.sum(-1) << shift)


def _columns(x, n: int):
    """The last n columns of rows x, step-major (step i = column
    n_cols-1-i), as int64."""
    return x[:, x.shape[1] - n:].flip(1).long()


def _place(rows, n_cols: int):
    """(B, n) step-major values into zero (B, n_cols) int32 rows."""
    out = torch.zeros((rows.shape[0], n_cols), dtype=torch.int64,
                      device=rows.device)
    out[:, :rows.shape[1]] = rows
    return _to_i32(out)


def encode_literals_ref(e_u, words, num, order):
    """Plain PyTorch literal encode; same arguments and results as
    ``encode_literals``."""
    dev = e_u.device
    B, n_cols = words.shape
    steps = steps_of("literals", num, n_cols)
    n = int(steps.max()) if B else 0
    w = _columns(words, n) & _M32
    sym = (w[:, :, None] >> torch.tensor([0, 8, 16, 24], device=dev)) & 255
    e = e_u.long().gather(1, sym.reshape(B, n * 4)).reshape(B, n, 4)
    s0 = torch.full((B, 4), C.U_STATES, dtype=torch.int64, device=dev)
    bits, n_b, s = _e_steps((e & 0x7FFF) - 2048, e >> 15, s0, steps)
    lo, meta = _groups(bits.flip(-1), n_b.flip(-1), 8)   # lane 3 at bit 0
    return _place(lo, n_cols), _place(meta, n_cols), _to_i32(s)


def _lm_symbol(v, t1: int, t2: int, t3: int):
    sym = torch.where(v < 16, v, 16 + (v >= t1).long() + (v >= t2).long()
                      + (v >= t3).long())
    return sym.clamp(0, 19)


def _d_symbol(v, table):
    di = torch.where(
        v < 60, v,
        torch.where(v < 1020, ((v - 60) >> 4) + 64,
                    torch.where(v < 16380, ((v - 1020) >> 8) + 128,
                                ((v - 16380) >> 12) + 192)))
    return table[di.clamp(0, 255)]


def encode_lmds_ref(e_l, e_m, e_d, lm, d, num, order):
    """Plain PyTorch L/M/D encode; same arguments and results as
    ``encode_lmds``."""
    dev = lm.device
    B, n_cols = lm.shape
    steps = steps_of("lmds", num, n_cols)
    n = int(steps.max()) if B else 0
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    lmv = _columns(lm, n)
    v = torch.stack([lmv & 0xFFFF, lmv >> 16, _columns(d, n)], -1)
    sym = torch.stack([_lm_symbol(v[..., 0], 20, 28, 60),
                       _lm_symbol(v[..., 1], 24, 56, 312),
                       _d_symbol(v[..., 2], t(C.D_BASE_FROM_VALUE))], -1)
    extra = torch.stack([t(C.L_EXTRA_BITS)[sym[..., 0]],
                         t(C.M_EXTRA_BITS)[sym[..., 1]],
                         t(C.D_EXTRA_BITS)[sym[..., 2]]], -1)
    base = torch.stack([t(C.L_BASE_VALUE)[sym[..., 0]],
                        t(C.M_BASE_VALUE)[sym[..., 1]],
                        t(C.D_BASE_VALUE)[sym[..., 2]]], -1)
    e = torch.stack([tab.long().gather(1, sym[..., j].reshape(B, n))
                     .reshape(B, n) for j, tab in enumerate((e_l, e_m, e_d))],
                    -1)
    s0 = torch.tensor([[C.L_STATES, C.M_STATES, C.D_STATES]],
                      device=dev).repeat(B, 1)
    bits, n_b, s = _e_steps((e & 0x7FFF) - 2048, e >> 15, s0, steps)
    active = (torch.arange(n, device=dev)[None, :] < steps[:, None])[..., None]
    pv = torch.where(active, ((v - base) & _M32) | ((bits << extra) & _M32), 0)
    pn = torch.where(active, extra + n_b, 0)
    lo, meta = _groups(pv.flip(-1), pn.flip(-1), 22)     # D at bit 0
    return _place(lo, n_cols), _place(meta, n_cols), _to_i32(s)


# --- comparisons and the JAX kernels' layout -----------------------------------

def defined_columns(kind: str, outs, num):
    """(glo, gmeta, states) with the columns at and past each row's step
    count set to 0: the part of the outputs the contract defines."""
    glo, gmeta, fs = outs
    steps = steps_of(kind, num.to(glo.device), glo.shape[1])
    keep = (torch.arange(glo.shape[1], device=glo.device)[None, :]
            < steps[:, None])
    return torch.where(keep, glo, 0), torch.where(keep, gmeta, 0), fs


def from_jax_encode_args(kind: str, *args, device="cpu") -> dict:
    """Keyword arguments of ``encode_literals`` (kind ``"literals"``; args
    ``e_u, words, num``) or ``encode_lmds`` (``"lmds"``; args ``e_l, e_m,
    e_d, lm, d, num``) from the numpy arguments of ``encode_literals_pallas``
    / ``encode_lmds_pallas``: the (B, 128) broadcast counts become (B,),
    the ``R_ROWS`` padding rows stay as rows of count 0, and ``order`` is
    the slots longest first."""
    *arrays, num = args
    keys = ("e_u", "words") if kind == "literals" else (
        "e_l", "e_m", "e_d", "lm", "d")
    n = np.asarray(num)[:, 0]
    n_cols = np.asarray(arrays[-1]).shape[1]

    def t(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    return {**{k: t(x) for k, x in zip(keys, arrays)}, "num": t(n),
            "order": t(slot_order(steps_of(kind, n, n_cols)))}


def from_jax_encode_outputs(kind: str, outs, num) -> tuple:
    """The JAX kernels' results (glo, gmeta (B, n_cols), states (B, 128))
    in the port's layout, as CPU tensors: defined columns only, states
    (B, 4) or (B, 3)."""
    glo, gmeta, fs = (torch.from_numpy(np.array(o, np.int32)) for o in outs)
    lanes = 4 if kind == "literals" else 3
    n = torch.from_numpy(np.asarray(num)[:, 0].astype(np.int32))
    return defined_columns(kind, (glo, gmeta, fs[:, :lanes].contiguous()), n)
