"""Batched tANS stream decode as torch ops: the portable scans.

Counterpart of ``lzfse_rust_tpu/ops/fse_decode.py`` (the ``lax.scan``
versions of the literal and L/M/D decode), with its signatures. Every block
in flight decodes at once, one step per symbol group, each block reading
its own packed tables (``ops/table_build.py`` ``build_decode_tables``):

  U entry:  k | sym << 4 | delta << 12
  V entry:  k | v_bits << 4 | delta << 8 | hi << 17, value bases from v_base

Payloads are expanded to overlapping little-endian 4-byte windows, so a
pull is one gather: bits = (W[pos >> 3] >> (pos & 7)) & mask(n). Windows
are int32 bit patterns (JAX's are uint32); ``_pull`` widens the gathered
word to its unsigned value before the shift, so no sign bit reaches the
field. The CUDA kernels of ``ops/cuda_decode.py`` compute the same streams
on the serving path.
"""

from __future__ import annotations

import torch


def bytes_to_windows(payload: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 -> (B, P - 3) int32 overlapping LE 4-byte windows (the
    uint32 values' bit patterns)."""
    p = payload.long()
    w = (p[:, :-3] | (p[:, 1:-2] << 8) | (p[:, 2:-1] << 16)
         | (p[:, 3:] << 24))
    return (((w + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _pull(windows, pos, n):
    """Pull ``n`` bits ending at bit position ``pos`` (per batch row).
    Returns (bits, new position); bits are 0 below position 0."""
    new_pos = pos - n
    safe = new_pos.clamp(min=0)
    w = windows.gather(1, (safe >> 3)[:, None].clamp(
        max=windows.shape[1] - 1))[:, 0].long() & 0xFFFFFFFF
    bits = (w >> (safe & 7)) & ((1 << n.long()) - 1)
    return torch.where(new_pos < 0, 0, bits).int(), new_pos


def decode_literals_batch(u_packed, windows, init_states, init_pos, num,
                          n_steps: int):
    """Decode up to n_steps * 4 literals per block.

    u_packed: (B, 1024) int32; windows: (B, W) int32; init_states (B, 4);
    init_pos (B,); num (B,) literal counts. Returns (literals (B,
    n_steps * 4) uint8, final_states (B, 4) int32, final_pos (B,) int32).
    Steps at and past ceil(num / 4) emit their symbols but leave the states
    and position alone, as the JAX scan does."""
    B = u_packed.shape[0]
    states = [init_states[:, i].int() for i in range(4)]
    pos = init_pos.int()
    num = num.int()
    lits = torch.zeros((B, n_steps, 4), dtype=torch.uint8,
                       device=u_packed.device)
    for i in range(n_steps):
        active = (i * 4) < num
        for lane in range(4):
            s = states[lane]
            e = u_packed.gather(1, s.long().clamp(0, 1023)[:, None])[:, 0]
            k = e & 15
            lits[:, i, lane] = ((e >> 4) & 255).to(torch.uint8)
            delta = e >> 12
            bits, new_pos = _pull(windows, pos, k)
            pos = torch.where(active, new_pos, pos)
            states[lane] = torch.where(active, bits + delta, s)
    return lits.reshape(B, -1), torch.stack(states, dim=1), pos


def decode_lmds_batch(v_packed, v_base, windows, init_states, init_pos, num,
                      n_steps: int):
    """Decode up to n_steps L/M/D triples per block.

    v_packed/v_base: (B, 384) int32; init_states: (B, 3) absolute
    compound-table states (L at +0, M at +64, D at +128). Returns (lmds
    (B, n_steps, 3) int32, final_states (B, 3), final_pos (B,)). Inactive
    steps emit (0, 0, 0) rows."""
    B = v_packed.shape[0]

    def one(s, pos, active):
        idx = s.long().clamp(0, 383)[:, None]
        e = v_packed.gather(1, idx)[:, 0]
        base = v_base.gather(1, idx)[:, 0]
        k = e & 15
        nb = (e >> 4) & 15
        delta = (e >> 8) & 0x1FF   # bits 17+ carry the packed value base
        sbits, pos1 = _pull(windows, pos, k)
        vbits, pos2 = _pull(windows, pos1, nb)
        s_new = torch.where(active, sbits + delta, s)
        pos = torch.where(active, pos2, pos)
        return s_new, pos, torch.where(active, base + vbits, 0)

    sl, sm, sd = (init_states[:, i].int() for i in range(3))
    pos = init_pos.int()
    num = num.int()
    lmds = torch.zeros((B, n_steps, 3), dtype=torch.int32,
                       device=v_packed.device)
    for i in range(n_steps):
        active = i < num
        sl, pos, lmds[:, i, 0] = one(sl, pos, active)
        sm, pos, lmds[:, i, 1] = one(sm, pos, active)
        sd, pos, lmds[:, i, 2] = one(sd, pos, active)
    return lmds, torch.stack([sl, sm, sd], dim=1), pos
