"""Batched tANS decode-table construction as torch ops.

Counterpart of ``lzfse_rust_tpu/ops/table_build.py``, with its signatures
and its packed layouts. Where the reference builds tables with a sequential
per-symbol loop (src/fse/decoder.rs:244-335), every state of every block is
built at once: state s belongs to the symbol whose cumulative-weight
interval holds s, and its rank j = s - cum[sym] gives (k, delta) as the
reference's inner loops do. States at or past the normalized total become
self-latching entries (decoder.rs:283-291).

  v tables: (B, 384) L|M|D states, packed k | v_bits << 4 | delta << 8 |
            hi << 17 (hi: value base for L/M, D symbol index for D)
  u tables: (B, 1024) packed k | sym << 4 | delta << 12, or the compact
            (B, 384) u3 layout of the literal kernel (``_v3``)

Arithmetic is int64 on values that fit int32 for any weights the format
accepts (each class's total at most its state count); results are int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import constants as C


def _bit_length(w: torch.Tensor) -> torch.Tensor:
    """32 - clz(w) for 0 <= w < 2**31."""
    w = w.long()
    n = torch.zeros_like(w)
    for s in (16, 8, 4, 2, 1):
        big = (w >> s) > 0
        n = torch.where(big, n + s, n)
        w = torch.where(big, w >> s, w)
    return n + (w > 0).long()


def _shl(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x << k as XLA shifts: 0 for k outside [0, 32)."""
    ok = (k >= 0) & (k < 32)
    return torch.where(ok, x << k.clamp(0, 31), 0)


def _shr(n: int, k: torch.Tensor) -> torch.Tensor:
    """n >> k as XLA shifts: 0 for k outside [0, 32)."""
    ok = (k >= 0) & (k < 32)
    return torch.where(ok, n >> k.clamp(0, 31), 0)


def _const(values, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=dev)


def _build_block(w: torch.Tensor, n_states: int, offset: int,
                 sym_a: torch.Tensor, sym_b: torch.Tensor):
    """One class's decode table rows for a batch: (k, a, b, delta), each
    (B, n_states) int32, ``a``/``b`` gathered per state from the per-symbol
    vectors ``sym_a``/``sym_b`` (extra bits and base values for V tables,
    symbol index and zeros for U tables); a latch state's are 0."""
    w = w.long()
    B, S = w.shape
    dev = w.device
    n_bits = int(np.log2(n_states))
    cum_inc = torch.cumsum(w, dim=1)
    cum_exc = cum_inc - w
    total = cum_inc[:, -1]
    states = torch.arange(n_states, device=dev)
    sym = torch.searchsorted(cum_inc.contiguous(),
                             states.expand(B, n_states).contiguous(),
                             right=True).clamp(max=S - 1)
    wsym = w.gather(1, sym)
    j = states[None, :] - cum_exc.gather(1, sym)
    k = (n_bits + 1) - _bit_length(wsym.clamp(min=1))
    x = _shr(n_states << 1, k) - wsym
    in_head = j < x
    k_e = torch.where(in_head, k, k - 1)
    delta = torch.where(in_head, _shl(wsym + j, k) - n_states,
                        _shl(j - x, (k - 1).clamp(min=0))) + offset
    a_e = sym_a[sym]
    b_e = sym_b[sym]
    valid = states[None, :] < total[:, None]
    k_e = torch.where(valid, k_e, 0)
    a_e = torch.where(valid, a_e, 0)
    b_e = torch.where(valid, b_e, 0)
    delta = torch.where(valid, delta, states[None, :] + offset)
    return tuple(_wrap(v) for v in (k_e, a_e, b_e, delta))


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _v_tables(w: torch.Tensor):
    """The L|M|D tables of weights (B, 360): (v_packed, v_base)."""
    dev = w.device
    wl = w[:, :C.L_TOP]
    wm = w[:, C.L_TOP:C.M_TOP]
    wd = w[:, C.M_TOP:C.D_TOP]
    lk, lbits, lbase, ldelta = _build_block(
        wl, C.L_STATES, 0, _const(C.L_EXTRA_BITS, dev),
        _const(C.L_BASE_VALUE, dev))
    mk, mbits, mbase, mdelta = _build_block(
        wm, C.M_STATES, C.L_STATES, _const(C.M_EXTRA_BITS, dev),
        _const(C.M_BASE_VALUE, dev))
    dk, dbits, dbase, ddelta = _build_block(
        wd, C.D_STATES, C.L_STATES + C.M_STATES, _const(C.D_EXTRA_BITS, dev),
        _const(C.D_BASE_VALUE, dev))
    v_k = torch.cat([lk, mk, dk], dim=1).long()
    v_bits = torch.cat([lbits, mbits, dbits], dim=1).long()
    v_base = torch.cat([lbase, mbase, dbase], dim=1)
    v_delta = torch.cat([ldelta, mdelta, ddelta], dim=1).long()
    # the D lane's hi is the first D symbol whose base is the state's
    d_base = _const(C.D_BASE_VALUE, dev)
    iota = torch.arange(C.D_SYMBOLS, device=dev)
    d_sym = torch.where(d_base[None, None, :] == dbase.long()[:, :, None],
                        iota, C.D_SYMBOLS).argmin(dim=2)
    v_hi = torch.cat([lbase.long(), mbase.long(), d_sym], dim=1)
    v_packed = v_k | (v_bits << 4) | (v_delta << 8) | (v_hi << 17)
    return _wrap(v_packed), v_base


def _u_block(wu: torch.Tensor):
    """The literal class's (k, sym, _, delta) rows, (B, 1024) each."""
    dev = wu.device
    return _build_block(
        wu, C.U_STATES, 0, torch.arange(C.U_SYMBOLS, device=dev),
        torch.zeros(C.U_SYMBOLS, dtype=torch.int64, device=dev))


def build_decode_tables(weights: torch.Tensor):
    """weights: (B, 360) -> (v_packed (B, 384), v_base (B, 384),
    u_packed (B, 1024)), all int32."""
    w = weights.long()
    v_packed, v_base = _v_tables(w)
    uk, usym, _, udelta = _u_block(w[:, C.D_TOP:C.U_TOP])
    u_packed = uk.long() | (usym.long() << 4) | (udelta.long() << 12)
    return v_packed, v_base, _wrap(u_packed)


def build_decode_tables_v3(weights: torch.Tensor):
    """weights: (B, 360) -> (v_packed (B, 384), u3 (B, 384), tot (B,)),
    all int32: the decode kernels' tables, as ``native.build_tables3_batch``
    builds them on the host.

    u3 words [0, 256) hold the byte-packed symbol of each state (state i in
    byte i & 3 of word i >> 2); words [256, 384) the per-symbol aux
    halfwords B | k0 << 11 (0 for zero-weight symbols); tot the U-weight
    totals (states >= tot latch)."""
    B = weights.shape[0]
    w = weights.long()
    wu = w[:, C.D_TOP:C.U_TOP]
    v_packed, _ = _v_tables(w)
    usym = _u_block(wu)[1]
    s4u = usym.long().reshape(B, 256, 4)
    u_sym_w = (s4u[:, :, 0] | (s4u[:, :, 1] << 8) | (s4u[:, :, 2] << 16)
               | (s4u[:, :, 3] << 24))
    f = wu
    base = torch.cumsum(f, dim=1) - f
    k0 = 11 - _bit_length(f.clamp(min=1))
    x = _shr(C.U_STATES << 1, k0) - f
    aux = torch.where(f > 0, (base + x) | (k0 << 11), 0)
    ua = aux.reshape(B, 128, 2)
    u_aux_w = ua[:, :, 0] | (ua[:, :, 1] << 16)
    u3 = torch.cat([u_sym_w, u_aux_w], dim=1)
    return v_packed, _wrap(u3), _wrap(f.sum(dim=1))
