"""Per-block tANS encode tables, built on the device with torch ops.

Counterpart of ``build_encode_tables`` in ``lzfse_rust_tpu/ops/fse_encode.py``
(encoder.rs:219-240 vectorised). Each symbol of a block's L, M, D and U
classes gets one packed int32 entry ``(t_k + 2048) | t_w << 15`` with

    k   = (n_bits + 1) - bit_length(w)      (n_states = 2**n_bits)
    t_k = 1024 * k - (w << k),   t_w = n_states + cum_exc(w) - w

and ``t_k = -n_states``, ``t_w = 0`` for a symbol of weight 0. The encode
kernels decode an entry as ``n_b = (t_k + s) >> 10``,
``s' = t_w + (s >> n_b)``.
"""

from __future__ import annotations

import torch

from ..base import constants as C

# (first column, end column, states) of the L, M, D and U classes in a
# (B, 360) weights row
_CLASSES = ((0, C.L_TOP, C.L_STATES), (C.L_TOP, C.M_TOP, C.M_STATES),
            (C.M_TOP, C.D_TOP, C.D_STATES), (C.D_TOP, C.U_TOP, C.U_STATES))


def _bit_length(w: torch.Tensor) -> torch.Tensor:
    """Bits needed for each value of ``w`` (0 <= w < 2**32), exactly:
    ``32 - clz(w)``."""
    n = torch.zeros_like(w)
    x = w
    for sh in (16, 8, 4, 2, 1):
        big = x >= (1 << sh)
        n = n + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return n + (x > 0).long()


def build_encode_tables(weights: torch.Tensor):
    """weights (B, 360), any integer type, on any device -> packed E tables
    ``(e_l (B, 20), e_m (B, 20), e_d (B, 64), e_u (B, 256))``, int32 and
    contiguous, on the same device. Arithmetic is int64 and wraps to int32
    at the end, as the JAX twin's int32 arithmetic does."""
    if weights.dim() != 2 or weights.shape[1] != C.N_WEIGHTS:
        raise ValueError(f"weights must be (B, {C.N_WEIGHTS}), got "
                         f"{tuple(weights.shape)}")
    out = []
    for a, b, n_states in _CLASSES:
        w = weights[:, a:b].long()
        n_bits = n_states.bit_length() - 1
        cum_exc = torch.cumsum(w, 1) - w
        k = (n_bits + 1) - _bit_length(w.clamp(min=1))
        # a shift out of [0, 32) gives 0, as XLA's shift_left does
        shifted = torch.where((k >= 0) & (k < 32), w << k.clamp(0, 31), 0)
        t_k = torch.where(w == 0, -n_states, 1024 * k - shifted)
        t_w = torch.where(w == 0, 0, n_states + cum_exc - w)
        e = (t_k + 2048) | (t_w << 15)
        out.append((((e + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32))
    return tuple(out)
