"""Batched FSE stream decode: the CUDA kernels, their plain versions, and the
adapters that carry the JAX kernels' arguments and results across.

Counterpart of ``lzfse_rust_tpu/ops/pallas_decode.py``. The two kernels
(``csrc/fse_decode.cu``) compute what ``decode_literals_pallas`` and
``decode_lmds_pallas`` compute, in a layout that suits the card:

* ``tables`` (B, 384) int32: the u3 (literal) or v (L/M/D) tables that
  ``native.build_tables3_batch`` writes;
* ``words`` 1-D int32: little-endian payload words; block b's stream is
  ``words[word_off[b] : word_off[b] + word_len[b]]`` and reads past it
  give zero bits;
* ``states`` (B, 4) literal or (B, 3) L/M/D initial states (the L/M/D
  class offsets already added), ``pos``/``num`` (B,) bit positions and
  counts, ``tot`` (B,) literal latch thresholds;
* dense outputs: block b's step j lands at ``out[out_off[b] + j]`` for
  ``j < ceil(num/4)`` (literals, 4 bytes per word, little-endian) or
  ``j < num`` (``lm = l | m << 16`` and raw ``d``); ``n_out`` is the
  output length. Final states (B, 4)/(B, 3) and final positions (B,).

All tensors are int32, contiguous, on one device. On a CUDA device the
wrappers launch the kernel or raise; only for CPU tensors do they run the
plain version. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

from ..runtime import cuda_lib

# kernel launches per wrapper, for checks that a run went through them
launches = {"decode_literals": 0, "decode_lmds": 0}

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "fse_decode.cu"
# the source line that sets both kernels' streams per CUDA block
STREAMS_LINE = re.compile(r"^constexpr int kStreams = (\d+);$", re.M)


def source_constant(path: pathlib.Path, pattern: re.Pattern, name: str,
                    source: str | None = None) -> int:
    """The integer that the one line of ``path`` (or of the given source
    text) matching ``pattern`` sets; raises unless exactly one matches."""
    text = path.read_text() if source is None else source
    found = pattern.findall(text)
    if len(found) != 1:
        raise RuntimeError(f"{path.name}: expected one {name} line, "
                           f"found {len(found)}")
    return int(found[0])


def streams_per_block(source: str | None = None) -> int:
    """Streams per CUDA block of both decode kernels, as ``fse_decode.cu``
    (or the given source text) sets it; needs no build."""
    return source_constant(SOURCE, STREAMS_LINE, "kStreams", source)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def out_offsets(counts: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense output offsets (exclusive prefix sum, int32) and the total."""
    c = np.maximum(np.asarray(counts, np.int64), 0)
    off = np.concatenate(([0], np.cumsum(c)[:-1])) if len(c) else c
    total = int(c.sum())
    if total >= 2**31:
        raise ValueError(f"{total} output words exceed int32 offsets")
    return off.astype(np.int32), total


def literal_counts(num: np.ndarray) -> np.ndarray:
    """Output words per literal block: one per 4 literals."""
    return (np.maximum(np.asarray(num, np.int64), 0) + 3) // 4


def _check(name: str, lanes: int, **tensors) -> torch.device:
    """Validate dtype, contiguity, device and shape; return the device."""
    tab = tensors["tables"]
    if tab.dim() != 2 or tab.shape[1] != 384:
        raise ValueError(f"{name}: tables must be (B, 384), got "
                         f"{tuple(tab.shape)}")
    B = tab.shape[0]
    want = {"tables": (B, 384), "states": (B, lanes)}
    for key, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.device != tab.device:
            raise ValueError(f"{name}: {key} is on {t.device}, tables on "
                             f"{tab.device}")
        if key == "words":
            if t.dim() != 1:
                raise ValueError(f"{name}: words must be 1-D")
        elif tuple(t.shape) != want.get(key, (B,)):
            raise ValueError(f"{name}: {key} must be {want.get(key, (B,))}, "
                             f"got {tuple(t.shape)}")
    return tab.device


def _pointers(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def decode_literals(tables, words, word_off, word_len, states, pos, num, tot,
                    out_off, n_out: int):
    """Literal decode (4 interleaved states). Returns (packed literal words
    (n_out,), final states (B, 4), final positions (B,)), all int32."""
    dev = _check("decode_literals", 4, tables=tables, words=words,
                 word_off=word_off, word_len=word_len, states=states,
                 pos=pos, num=num, tot=tot, out_off=out_off)
    if dev.type == "cpu":
        return decode_literals_ref(tables, words, word_off, word_len, states,
                                   pos, num, tot, out_off, n_out)
    if dev.type != "cuda":
        raise ValueError(f"decode_literals: no kernel for device {dev}")
    B = tables.shape[0]
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    fs = torch.empty((B, 4), dtype=torch.int32, device=dev)
    fp = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = cuda_lib.lib().lzt_decode_literals(
                *_pointers(tables, words, word_off, word_len, states, pos,
                           num, tot, out_off, out, fs, fp),
                B, words.numel(), n_out,
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(rc, "decode_literals")
        launches["decode_literals"] += 1
    return out, fs, fp


def decode_lmds(tables, words, word_off, word_len, states, pos, num,
                out_off, n_out: int):
    """L/M/D decode (3 interleaved states). Returns (lm (n_out,),
    d (n_out,), final states (B, 3), final positions (B,)), all int32."""
    dev = _check("decode_lmds", 3, tables=tables, words=words,
                 word_off=word_off, word_len=word_len, states=states,
                 pos=pos, num=num, out_off=out_off)
    if dev.type == "cpu":
        return decode_lmds_ref(tables, words, word_off, word_len, states,
                               pos, num, out_off, n_out)
    if dev.type != "cuda":
        raise ValueError(f"decode_lmds: no kernel for device {dev}")
    B = tables.shape[0]
    lm = torch.empty(n_out, dtype=torch.int32, device=dev)
    d = torch.empty(n_out, dtype=torch.int32, device=dev)
    fs = torch.empty((B, 3), dtype=torch.int32, device=dev)
    fp = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = cuda_lib.lib().lzt_decode_lmds(
                *_pointers(tables, words, word_off, word_len, states, pos,
                           num, out_off, lm, d, fs, fp),
                B, words.numel(), n_out,
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(rc, "decode_lmds")
        launches["decode_lmds"] += 1
    return lm, d, fs, fp


# --- plain versions -----------------------------------------------------------
#
# Vectorised over blocks, a Python loop over steps up to the batch's largest
# count. Everything is int64, so ``>>`` never shifts a sign bit into the
# extracted bits; results wrap to int32 as the kernels' do.

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return _wrap32(x).to(torch.int32)


class _Stream:
    """Bit reads from each block's payload words (zero past them)."""

    def __init__(self, words, word_off, word_len):
        n_words = words.numel()
        self.wd = (words.long() & 0xFFFFFFFF) if n_words else \
            torch.zeros(1, dtype=torch.int64, device=words.device)
        self.base = word_off.long()[:, None]
        ln = word_len.long()[:, None]
        room = n_words - self.base
        self.lim = torch.where(
            (self.base < 0) | (ln <= 0) | (room <= 0), 0,
            torch.minimum(ln, room))

    def _word(self, w):
        ok = w < self.lim
        return torch.where(ok, self.wd[torch.where(ok, self.base + w, 0)], 0)

    def read(self, p, n):
        """Bits [p, p + n) (n <= 32), zero where p < 0."""
        pc = p.clamp(min=0)
        w = pc >> 5
        # bits 31.. of the high word lie above any n <= 32 field that starts
        # in the low word's bit 31 or below; dropping them keeps v < 2**63
        v = self._word(w) | ((self._word(w + 1) & 0x7FFFFFFF) << 32)
        bits = (v >> (pc & 31)) & ((torch.ones_like(n) << n) - 1)
        return torch.where(p < 0, 0, bits)


def _dense(rows: torch.Tensor, counts: torch.Tensor, out_off, n_out: int):
    """Scatter each row's first ``counts`` values to ``out_off`` onward."""
    j = torch.arange(rows.shape[1], device=rows.device)
    idx = out_off.long()[:, None] + j[None, :]
    keep = (j[None, :] < counts[:, None]) & (idx >= 0) & (idx < n_out)
    out = torch.zeros(n_out, dtype=torch.int64, device=rows.device)
    out[idx[keep]] = rows[keep]
    return _to_i32(out)


def decode_literals_ref(tables, words, word_off, word_len, states, pos, num,
                        tot, out_off, n_out: int):
    """Plain PyTorch literal decode; same arguments and results as
    ``decode_literals``."""
    dev = tables.device
    tab = tables.long() & 0xFFFFFFFF
    src = _Stream(words, word_off, word_len)
    s = states.long()
    p = pos.long()
    t = tot.long()[:, None]
    steps = (num.long().clamp(min=0) + 3) // 4
    n_max = int(steps.max()) if steps.numel() else 0
    rows = torch.zeros((tab.shape[0], n_max), dtype=torch.int64, device=dev)
    byte_shift = torch.tensor([0, 8, 16, 24], device=dev)
    for j in range(n_max):
        col = ((s >> 2) & 127) | (((s >> 9) & 1) << 7)
        sym = (tab.gather(1, col) >> ((s & 3) << 3)) & 255
        aw = tab.gather(1, 256 + (sym >> 1))
        aux = (aw >> ((sym & 1) << 4)) & 0x7FFF
        bv = aux & 2047
        k0 = aux >> 11
        a = (torch.full_like(k0, 2048) >> k0) - bv
        head = s < bv
        k = torch.where(head, k0, k0 - 1).clamp(min=0)
        delta = torch.where(head, ((s + a) << k0) - 1024,
                            (s - bv) << (k0 - 1).clamp(min=0))
        latch = s >= t
        k = torch.where(latch, 0, k)
        delta = torch.where(latch, s, delta)
        sym = torch.where(latch, 0, sym)
        ksum = k.cumsum(1)
        bits = src.read(p[:, None] - ksum, k)
        active = j < steps
        s = torch.where(active[:, None], _wrap32(bits + delta), s)
        p = torch.where(active, p - ksum[:, 3], p)
        rows[:, j] = (sym << byte_shift).sum(1)
    return (_dense(rows, steps, out_off, n_out), _to_i32(s), _to_i32(p))


def decode_lmds_ref(tables, words, word_off, word_len, states, pos, num,
                    out_off, n_out: int):
    """Plain PyTorch L/M/D decode; same arguments and results as
    ``decode_lmds``."""
    dev = tables.device
    tab = tables.long() & 0xFFFFFFFF
    src = _Stream(words, word_off, word_len)
    s = states.long()
    p = pos.long()
    steps = num.long().clamp(min=0)
    n_max = int(steps.max()) if steps.numel() else 0
    B = tab.shape[0]
    lm = torch.zeros((B, n_max), dtype=torch.int64, device=dev)
    dd = torch.zeros((B, n_max), dtype=torch.int64, device=dev)
    is_d = torch.tensor([False, False, True], device=dev)
    for j in range(n_max):
        hi7 = s >> 7
        chunk = torch.where((hi7 & 2) != 0, 2, hi7 & 1)
        e = tab.gather(1, chunk * 128 + (s & 127))
        k = e & 15
        nb = (e >> 4) & 15
        delta = (e >> 8) & 0x1FF
        hi = (e >> 17) & 0x7FFF
        d_base = ((4 + (hi & 3)) << (hi >> 2).clamp(max=15)) - 4
        base = torch.where(is_d, d_base, hi)
        knb = k + nb
        p_state = p[:, None] - (knb.cumsum(1) - knb) - k
        both = src.read(p_state - nb, knb)
        vbits = both & ((torch.ones_like(nb) << nb) - 1)
        sbits = torch.where(p_state < 0, 0, both >> nb)
        value = base + vbits
        active = j < steps
        s = torch.where(active[:, None], _wrap32(sbits + delta), s)
        p = torch.where(active, p - knb.sum(1), p)
        lm[:, j] = value[:, 0] + (value[:, 1] << 16)
        dd[:, j] = value[:, 2]
    return (_dense(lm, steps, out_off, n_out), _dense(dd, steps, out_off, n_out),
            _to_i32(s), _to_i32(p))


# --- adapters to and from the JAX kernels' layout -------------------------------

def from_jax_decode_args(kind: str, tables, win_words, init_states, init_pos,
                         num, tot=None, device="cpu") -> dict:
    """Keyword arguments of ``decode_literals`` (kind ``"literals"``) or
    ``decode_lmds`` (``"lmds"``) from the numpy arguments of
    ``decode_literals_pallas``/``decode_lmds_pallas``: tables (B, 384),
    win_words (B, W), states/positions/counts (B, 128), tot (B,). Block b
    reads row b of win_words, so both sides see the same words."""
    lanes = {"literals": 4, "lmds": 3}[kind]
    win = np.ascontiguousarray(win_words, np.int32)
    B, W = win.shape
    n = np.asarray(num)[:, 0].astype(np.int32)
    counts = literal_counts(n) if kind == "literals" else n
    out_off, n_out = out_offsets(counts)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    args = dict(tables=t(tables), words=t(win.reshape(-1)),
                word_off=t(np.arange(B) * W), word_len=t(np.full(B, W)),
                states=t(np.asarray(init_states)[:, :lanes]),
                pos=t(np.asarray(init_pos)[:, 0]), num=t(n),
                out_off=t(out_off), n_out=n_out)
    if kind == "literals":
        args["tot"] = t(tot)
    return args


def to_jax_decode_args(lit: dict, lmd: dict) -> dict:
    """The inverse of ``from_jax_decode_args`` for a pair of the port's
    argument dicts (``decode_literals``, ``decode_lmds``): the JAX kernels'
    arguments, numpy, under the keys of ``parallel/mesh.
    sharded_pallas_entropy_decode``. Stream b's words become row b of a
    (B, W) array, zero past its ``word_len``; W is the longest stream."""
    out = {}
    for args, tab, pre in ((lit, "u3_tabs", "lit"), (lmd, "v_tabs", "lmd")):
        a = {k: v.cpu().numpy() if torch.is_tensor(v) else v
             for k, v in args.items()}
        B = a["tables"].shape[0]
        W = max(int(a["word_len"].max()) if B else 0, 1)
        col = np.arange(W)
        idx = a["word_off"][:, None].astype(np.int64) + col
        src = a["words"] if a["words"].size else np.zeros(1, np.int32)
        keep = (col < a["word_len"][:, None]) & (idx < a["words"].size)
        words = np.where(keep, src[np.where(keep, idx, 0)], 0)

        def lanes(x):
            return np.repeat(x[:, None], 128, 1).astype(np.int32)

        states = np.zeros((B, 128), np.int32)
        states[:, :a["states"].shape[1]] = a["states"]
        out.update({tab: a["tables"], f"{pre}_words": words.astype(np.int32),
                    f"{pre}_states": states, f"{pre}_pos": lanes(a["pos"]),
                    f"{pre}_num": lanes(a["num"])})
    out["lit_tot"] = lit["tot"].cpu().numpy()
    return out


def from_jax_decode_outputs(kind: str, outs, num) -> tuple:
    """The JAX kernels' results in the port's layout (numpy): padded
    (B, n) rows become dense arrays, (B, 128) states and positions become
    (B, lanes) and (B,)."""
    n = np.maximum(np.asarray(num)[:, 0].astype(np.int64), 0)
    outs = [np.asarray(o) for o in outs]
    if kind == "literals":
        counts, lanes, rows = literal_counts(n), 4, outs[:1]
    else:
        counts, lanes, rows = n, 3, outs[:2]
    dense = [np.concatenate([r[b, :c] for b, c in enumerate(counts)])
             .astype(np.int32) if len(counts) else np.zeros(0, np.int32)
             for r in rows]
    return (*dense, outs[-2][:, :lanes].astype(np.int32),
            outs[-1][:, 0].astype(np.int32))
