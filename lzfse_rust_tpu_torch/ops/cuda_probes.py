"""Probe kernels: the TPU tools' op-mix microbenchmarks as CUDA kernels,
their plain versions, and the table of their bodies.

Counterpart of the three Pallas kernels of the JAX package's tools:

* ``probe_step`` -- ``timed.<locals>.go`` (``tools/microbench_step.py``):
  ``n_steps`` applications of a literal-step body to an int32 tile ``x``
  (8 * n_vregs, 128), with ``tab`` (8, G * tab_words) and ``chunk``
  (8, G * 256); the body gets the step index. Returns ``x`` after the last
  step.
* ``probe_chain`` -- ``run.<locals>.go`` (``tools/microbench_vpu.py``):
  ``n_steps`` x 32 applications of ``body(x, tab, j)``, j the op index
  0..31, to ``x`` (8, 128) with ``tab`` (8, 1024).
* ``probe_tput`` -- ``run_tp.<locals>.go`` (same file): per step, 8
  independent ops ``op(x + j, tab, j)``, summed, ``& 127``.

Row rho of ``x`` reads only row rho mod 8 of ``tab`` and ``chunk``; every
op works along the 128 lanes of a row (lane id ``lane``, section
``lane >> 4`` of G = 8, lane in section ``lane & 15``). The kernels take
the TPU tools' arrays as they are (same shapes and layout, int32), so no
adapter carries them across.

The TPU emulates a lookup into a wide table with 128-lane gathers and
select trees (``lookup_sec``, ``lookup_chunks``, ``chunk_word``,
``chunk_word_128``). Their value is one indexed load, which is what both
versions here do: ``lookup`` and ``chunk_word`` below.

All tensors are int32, contiguous, on one device. On a CUDA device the
wrappers launch the kernel (``csrc/probes.cu``) or raise; only for CPU
tensors do they run the plain version. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from ..runtime import cuda_lib
from .cuda_decode import _pointers, _wrap32

G = 8           # sections per row
N_OPS = 32      # ops per step of probe_chain
TPUT_WIDTH = 8  # independent ops per step of probe_tput

# Bodies in the order the TPU tools first call them; a body's index here is
# its number in csrc/probes.cu. Step bodies carry their tab_words.
STEP_BODIES = {
    "current": 1024, "indep_roll": 1024, "gathers_only": 1024,
    "lookup_only": 1024, "fast": 1024, "fast_nosplit": 1024,
    "lookup_8ch": 1024, "lookup_16ch": 2048, "lookup_32ch": 4096,
    "pair_64": 9216,
}
CHAIN_BODIES = ("add", "gather128", "roll", "select", "gather128_indep",
                "shift_pair", "gather16", "xor", "prefix_chain",
                "prefix_tree", "lit_step")
TPUT_BODIES = ("gather_x8", "roll_x8")

# kernel launches per wrapper, for checks that a run went through them
launches = {"probe_step": 0, "probe_chain": 0, "probe_tput": 0}

_M32 = 0xFFFFFFFF


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def step_memory(body: str) -> str:
    """Where ``probe_step``'s kernel keeps the row's table, as
    ``csrc/probes.cu`` decides it: ``"shared"`` when the table and chunk
    rows fit in one CUDA block's shared memory, else ``"global"`` (read
    through L1/L2). The chunk row is always shared. Loads the kernel
    library."""
    b = _index("step_memory", STEP_BODIES, body)
    return ("global", "shared")[cuda_lib.lib().lzt_probe_step_shared(b)]


# --- validation and launch ------------------------------------------------------

def _check(name: str, tensors: dict, shapes: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {shapes[key]}, got "
                             f"{tuple(t.shape)}")
    return dev


def _index(name: str, bodies, body: str) -> int:
    names = list(bodies)
    if body not in names:
        raise ValueError(f"{name}: unknown body {body!r}; one of {names}")
    return names.index(body)


def _launch(name: str, entry: str, dev, body: int, tensors: tuple,
            counts: tuple):
    """Launch ``entry(body, *pointers, out, *counts, stream)``; the output
    has the shape of the last input (the tile ``x``)."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned (the "
                         f"kernels load rows as int4)")
    out = torch.empty_like(tensors[-1])
    with torch.cuda.device(dev):
        rc = getattr(cuda_lib.lib(), entry)(
            body, *_pointers(*tensors, out), *counts,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, name)
    launches[name] += 1
    return out


def probe_step(body: str, tab, chunk, x, n_steps: int):
    """``n_steps`` applications of step body ``body`` to ``x``
    (8 * n_vregs, 128), 1 <= n_vregs <= 32; ``tab`` (8, G * tab_words of
    the body), ``chunk`` (8, G * 256). Returns the final tile."""
    b = _index("probe_step", STEP_BODIES, body)
    rows = x.shape[0] if x.dim() == 2 else -1
    if rows < 8 or rows % 8 or rows > 256 or n_steps < 0:
        raise ValueError(f"probe_step: x must be (8 * n_vregs, 128) with "
                         f"1 <= n_vregs <= 32 and n_steps >= 0, got "
                         f"{tuple(x.shape)}, {n_steps}")
    dev = _check("probe_step", dict(tab=tab, chunk=chunk, x=x),
                 dict(tab=(8, G * STEP_BODIES[body]), chunk=(8, G * 256),
                      x=(rows, 128)))
    if dev.type == "cpu":
        return probe_step_ref(body, tab, chunk, x, n_steps)
    return _launch("probe_step", "lzt_probe_step", dev, b, (tab, chunk, x),
                   (rows, n_steps))


def probe_chain(body: str, tab, x, n_steps: int):
    """``n_steps`` x 32 applications of chain body ``body`` to ``x`` (8, 128)
    with ``tab`` (8, 1024). Returns the final tile."""
    b = _index("probe_chain", CHAIN_BODIES, body)
    return _chain_or_tput("probe_chain", "lzt_probe_chain", b, body, tab, x,
                          n_steps, probe_chain_ref)


def probe_tput(body: str, tab, x, n_steps: int):
    """``n_steps`` steps of 8 independent ops of ``body`` on ``x`` (8, 128)
    with ``tab`` (8, 1024), summed and masked to 7 bits per step."""
    b = _index("probe_tput", TPUT_BODIES, body)
    return _chain_or_tput("probe_tput", "lzt_probe_tput", b, body, tab, x,
                          n_steps, probe_tput_ref)


def _chain_or_tput(name, entry, b, body, tab, x, n_steps, ref):
    if n_steps < 0:
        raise ValueError(f"{name}: n_steps must be >= 0, got {n_steps}")
    dev = _check(name, dict(tab=tab, x=x), dict(tab=(8, 1024), x=(8, 128)))
    if dev.type == "cpu":
        return ref(body, tab, x, n_steps)
    return _launch(name, entry, dev, b, (tab, x), (n_steps,))


# --- plain versions -----------------------------------------------------------
#
# Values are int64 tensors holding int32 values; a body's result wraps to
# int32 as the kernels' (and XLA's) int32 arithmetic does. Logical shifts
# mask to 32 bits first; ``>>`` on the int64 values is the int32 arithmetic
# shift. A roll is ``torch.roll`` along lanes (jnp.roll: out[j] = x[j - s]).

class _Row:
    """Lane constants and the rows' tables for one tile of R rows."""

    def __init__(self, tab, chunk, rows: int):
        dev = tab.device
        lane = torch.arange(128, device=dev)
        self.glane = lane & 15
        self.sec = lane >> 4
        pick = torch.arange(rows, device=dev) % 8
        self.tab = tab.long()[pick]
        self.chunk = None if chunk is None else chunk.long()[pick]

    def lookup(self, idx, n_chunks: int, tw: int):
        """``lookup_sec``/``lookup_chunks``: the section's table word at
        chunk ``(idx >> 7) & (n_chunks - 1)``, column ``idx & 127``."""
        col = self.sec * tw + (((idx >> 7) & (n_chunks - 1)) << 7) + (idx & 127)
        return self.tab.gather(1, col)

    def chunk_word(self, widx):
        """``chunk_word``: the section's chunk word, half by ``widx < 128``."""
        col = (self.sec * 256 + torch.where(widx < 128, 0, 128)
               + (widx & 127))
        return self.chunk.gather(1, col)

    def chunk_word_128(self, widx):
        """``chunk_word_128``: the section's first 128 chunk words."""
        col = self.sec * 256 + (widx & 127)
        return self.chunk.gather(1, col)

    def mroll(self, x, s: int):
        """``masked_roll``: roll by s, zero where ``lane & 15 < s``."""
        return torch.where(self.glane >= s, torch.roll(x, s, 1), 0)


def _funnel(wlo, whi, sh):
    """32 bits of ``whi:wlo`` from bit ``sh`` (0..31); the shift by 32 that
    ``sh == 0`` would need is guarded as in the TPU tool."""
    lo = wlo & _M32
    hi = whi & _M32
    return (lo >> sh) | torch.where(sh == 0, 0, (hi << (32 - sh)) & _M32)


def _indep_prefix(R: _Row, k):
    """Independent-roll prefix and fused bidirectional total: (ksum, t)."""
    f1, f2, f3 = R.mroll(k, 1), R.mroll(k, 2), R.mroll(k, 3)
    b1 = torch.where(R.glane < 3, torch.roll(k, 127, 1), 0)
    b2 = torch.where(R.glane < 2, torch.roll(k, 126, 1), 0)
    b3 = torch.where(R.glane < 1, torch.roll(k, 125, 1), 0)
    ksum = k + f1 + (f2 + f3)
    return ksum, ksum + b1 + (b2 + b3)


def _bits(R: _Row, ksum, widx, word):
    sh = ksum & 31
    return _funnel(word(widx), word(widx + 1), sh) & 1023


def _step_current(R, s, i):
    ent = R.lookup(s & 1023, 8, 1024)
    k = torch.where(R.glane < 4, ent & 15, 0)
    ksum = k + R.mroll(k, 1)
    ksum = ksum + R.mroll(ksum, 2)
    bits = _bits(R, ksum, (ksum + i) & 254, R.chunk_word)
    t = torch.where(R.glane == 3, ksum, 0)
    t = t + torch.roll(t, 127, 1)
    t = t + torch.roll(t, 126, 1)
    return (bits + (ent >> 12) + t) & 1023


def _step_indep_roll(R, s, i):
    ent = R.lookup(s & 1023, 8, 1024)
    k = torch.where(R.glane < 4, ent & 15, 0)
    ksum, t = _indep_prefix(R, k)
    bits = _bits(R, ksum, (ksum + i) & 254, R.chunk_word)
    return (bits + (ent >> 12) + t) & 1023


def _step_gathers_only(R, s, i):
    lo = s & 127
    acc = s
    for g in range(G):
        for c in range(8):
            acc = acc + R.tab.gather(1, g * 1024 + c * 128 + lo)
    for g in range(G):
        for c in range(4):
            acc = acc + R.chunk.gather(1, g * 256 + (c % 2) * 128 + lo)
    return acc & 1023


def _step_lookup_only(R, s, i):
    return (s + R.lookup(s & 1023, 8, 1024)) & 1023


def _step_fast(R, s, i):
    state = s & 1023
    # split_lookup: kd halfword-packed in 4 chunks, sym byte-packed in 2
    kd_i = state >> 1
    kd = R.tab.gather(1, R.sec * 1024 + kd_i)
    sy_i = state >> 2
    sy = R.tab.gather(1, R.sec * 1024 + torch.where(sy_i >> 7 == 0, 512, 640)
                      + (sy_i & 127))
    kdv = (kd & _M32) >> ((state & 1) << 4)
    k = kdv & 15
    delta = (kdv >> 4) & 1023
    sym = ((sy & _M32) >> ((state & 3) << 3)) & 255
    k = torch.where(R.glane < 4, k, 0)
    ksum, t = _indep_prefix(R, k)
    bits = _bits(R, ksum, (ksum + i) & 126, R.chunk_word_128)
    return (bits + delta + t + sym) & 1023


def _step_fast_nosplit(R, s, i):
    ent = R.lookup(s & 1023, 8, 1024)
    k = torch.where(R.glane < 4, ent & 15, 0)
    ksum, t = _indep_prefix(R, k)
    bits = _bits(R, ksum, (ksum + i) & 126, R.chunk_word_128)
    return (bits + (ent >> 12) + t) & 1023


def _step_lookup_n(n_chunks: int):
    tw = n_chunks * 128

    def body(R, s, i):
        return (s + R.lookup(s & (tw - 1), n_chunks, tw)) & 1023
    return body


def _step_pair_64(R, s, i):
    tw = 9216
    ent = R.lookup(s & 1023, 8, tw)
    k1 = ent & 15
    base = (ent >> 4) & 8191
    ksum = k1 + R.mroll(k1, 1)
    ksum = ksum + R.mroll(ksum, 2)
    widx = (ksum + i) & 126
    val = _funnel(R.chunk_word_128(widx), R.chunk_word_128(widx + 1),
                  ksum & 31)
    b1 = val & ((1 << k1) - 1)
    pair = R.lookup((1024 + base + b1) & (tw - 1), 64, tw)
    sym2 = (pair >> 8) & 255
    k2 = (pair >> 16) & 15
    delta2 = (pair >> 20) & 1023
    w2 = R.chunk_word_128((ksum + k2 + i) & 126)
    b2 = (w2 & _M32) & ((1 << k2) - 1)
    return (b2 + delta2 + sym2 + (pair & 255)) & 1023


_STEP = {"current": _step_current, "indep_roll": _step_indep_roll,
         "gathers_only": _step_gathers_only, "lookup_only": _step_lookup_only,
         "fast": _step_fast, "fast_nosplit": _step_fast_nosplit,
         "lookup_8ch": _step_lookup_n(8), "lookup_16ch": _step_lookup_n(16),
         "lookup_32ch": _step_lookup_n(32), "pair_64": _step_pair_64}


def probe_step_ref(body: str, tab, chunk, x, n_steps: int):
    """Plain PyTorch ``probe_step``; same arguments and result."""
    fn = _STEP[body]
    R = _Row(tab, chunk, x.shape[0])
    s = x.long()
    for i in range(n_steps):
        s = _wrap32(fn(R, s, i))
    return s.to(torch.int32)


def _lit_step(R, x):
    ent = R.tab[:, :128].gather(1, x & 127)
    k = ent & 15
    ksum = k + torch.roll(k, 1, 1) + (torch.roll(k, 2, 1)
                                      + torch.roll(k, 3, 1))
    w = R.tab[:, 128:256].gather(1, ksum & 127)
    return (w >> (k & 7)) & 127


def _prefix_chain(x):
    k = x & 15
    ks = k + torch.roll(k, 1, 1)
    return ks + torch.roll(ks, 2, 1)


def _prefix_tree(x):
    k = x & 15
    return k + torch.roll(k, 1, 1) + (torch.roll(k, 2, 1)
                                      + torch.roll(k, 3, 1))


# body(R, x, j) for the TPU tool's lambdas and local functions
_CHAIN = {
    "add": lambda R, x, j: x + 1,
    "gather128": lambda R, x, j: R.tab[:, :128].gather(1, x & 127),
    "roll": lambda R, x, j: torch.roll(x, 1, 1) + 1,
    "select": lambda R, x, j: torch.where(x > 64, x - 1, x + 1),
    "gather128_indep": lambda R, x, j: x + R.tab.gather(
        1, (j % 8) * 128 + ((x + j) & 127)),
    "shift_pair": lambda R, x, j: (x >> 1) ^ (x << 2),
    "gather16": lambda R, x, j: x + R.tab[:, :128].gather(1, x & 15),
    "xor": lambda R, x, j: x ^ 3,
    "prefix_chain": lambda R, x, j: _prefix_chain(x),
    "prefix_tree": lambda R, x, j: _prefix_tree(x),
    "lit_step": lambda R, x, j: _lit_step(R, x),
}

_TPUT = {
    "gather_x8": lambda R, x, j: R.tab[:, :128].gather(1, x & 127),
    "roll_x8": lambda R, x, j: torch.roll(x, (j % 7) + 1, 1),
}


def probe_chain_ref(body: str, tab, x, n_steps: int):
    """Plain PyTorch ``probe_chain``; same arguments and result."""
    fn = _CHAIN[body]
    R = _Row(tab, None, 8)
    s = x.long()
    for _ in range(n_steps):
        for j in range(N_OPS):
            s = _wrap32(fn(R, s, j))
    return s.to(torch.int32)


def probe_tput_ref(body: str, tab, x, n_steps: int):
    """Plain PyTorch ``probe_tput``; same arguments and result."""
    fn = _TPUT[body]
    R = _Row(tab, None, 8)
    s = x.long()
    for _ in range(n_steps):
        acc = sum(fn(R, _wrap32(s + j), j) for j in range(TPUT_WIDTH))
        s = _wrap32(acc) & 127
    return s.to(torch.int32)
