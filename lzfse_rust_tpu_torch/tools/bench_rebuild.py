"""The rebuild stage alone, on the host and on the card, on the serving
batch.

    python3 -m lzfse_rust_tpu_torch.tools.bench_rebuild

Port of the JAX package's ``tools/bench_rebuild.py``, with the device
rebuild beside it:

* host: after one warm-up, one ``decode_many`` on the card runs with
  ``native.flatten_rebuild`` wrapped so that its arguments are kept; every
  output is checked against its raw input (SHA-256). Then the call alone
  runs 9 times on those arguments (it writes the same bytes into the same
  outputs each time); the second-smallest is reported;
* device (what ``TorchDecoder(use_native_rebuild=False)`` runs after the
  decode kernels): the flatten (``ops/lz_rebuild.flatten_pieces``, with
  its host plan) and the rebuild kernel (``ops/cuda_rebuild.lz_rebuild``),
  each the mean of 5 runs between CUDA events after a warm-up; the
  kernel's output checked against the raw inputs; ``torch.profiler``
  tables of the flatten and of the kernel's parts (the row checks, the
  tiles, each doubling round with the positions still open before it, and the output pass); then the 134.6 MB of output to the host three
  ways, 5 runs each, second-smallest: straight into each container's bytes
  object (a pageable copy each), into one pinned buffer followed by one
  host copy into each bytes object, and the decoder's way: the pinned
  buffer, then 8 host threads copying 1 MiB pieces.

The last line is one JSON object.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..runtime.build import native_runtime
from ..utils.timing import cuda_ms
from .common import require_card, second_smallest, serving_pairs


def capture(dec, sources):
    """Run ``dec.decode_many(sources)`` and return (outputs, stats,
    (args, kwargs) of its ``flatten_rebuild`` call)."""
    native = native_runtime()
    real = native.flatten_rebuild
    calls = []

    def keep(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    native.flatten_rebuild = keep
    try:
        stats: dict = {}
        outs = dec.decode_many(sources, stats)
    finally:
        native.flatten_rebuild = real
    if len(calls) != 1:
        raise RuntimeError(f"decode_many called flatten_rebuild "
                           f"{len(calls)} times, expected once")
    return outs, stats, calls[0]


def _host_ms(fn, runs: int) -> float:
    """Second-smallest host milliseconds of ``runs`` calls, each ended by a
    synchronize."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return second_smallest(times) * 1e3


def out_to_host(out: torch.Tensor, out_off: np.ndarray, pinned=None,
                pool=None):
    """The output segments as bytes objects: copied from the card into each
    object's buffer, or (``pinned`` given) into ``pinned`` first and then
    into each object, by the threads of ``pool`` when given."""
    from ..models.decoder import copy_segments
    from ..runtime import native
    spans = list(zip(out_off[:-1].tolist(), out_off[1:].tolist()))
    if pinned is not None:
        pinned[:out.numel()].copy_(out)
        base = pinned.data_ptr()
        if pool is not None:
            return copy_segments(base, spans, pool)
    res, dsts = native.new_outputs(np.diff(out_off))
    for (a, b), dst in zip(spans, dsts.tolist()):
        if pinned is not None:
            ctypes.memmove(dst, base + a, b - a)
        elif b > a:
            buf = (ctypes.c_uint8 * (b - a)).from_address(dst)
            torch.from_numpy(np.ctypeslib.as_array(buf)).copy_(out[a:b])
    return res


def profile_flatten(dec, dense, conts, n_raw) -> str:
    """``torch.profiler`` table of three device flattens (host plan,
    uploads and torch ops), the top ops by CPU time and by CUDA time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(3):
            dec._flat_args(dense, conts, n_raw)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return (ka.table(sort_by="cpu_time_total", row_limit=14) + "\n"
            + ka.table(sort_by="cuda_time_total", row_limit=14))


def profile_kernel(args: dict) -> dict:
    """The rebuild's CUDA kernels in one call, from ``torch.profiler``:
    microseconds per kernel name (``lzr_tile``: init with in-row chains
    folded and in-tile links resolved; ``lzr_round``: the doubling rounds;
    ``lzr_out``: the gather), each round's in launch order (a round after
    nothing was left returns at once), and the positions still open before
    each round."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import cuda_rebuild as CR
    detail: dict = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        CR.lz_rebuild(**args, detail=detail)
        torch.cuda.synchronize()
    per, rounds = {}, []
    for ev in prof.events():
        name = ev.name
        if not name.startswith("lzr_") and "lzr_" in name:
            name = name[name.index("lzr_"):].split("(")[0]
        if name.startswith("lzr_"):
            us = ev.time_range.elapsed_us()
            per[name] = per.get(name, 0.0) + us
            if name == "lzr_round":
                rounds.append(round(us, 1))
    return {"kernel_us": per, "round_us": rounds,
            "unresolved": detail["unresolved"]}


def device_rebuild(dec, sources, raws) -> dict:
    """The device flatten, the rebuild kernel and the output's trip to the
    host, timed on the card's serving batch (see the module docstring)."""
    from ..ops import cuda_rebuild as CR
    dense, conts, n_raw = dec.flatten_inputs(sources)
    t = time.perf_counter()
    args = dec._flat_args(dense, conts, n_raw)[0]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    flatten_ms = cuda_ms(lambda: dec._flat_args(dense, conts, n_raw),
                         reps=5, warmup=1)
    from ..ops import lz_rebuild as LR
    plan_ms = _host_ms(lambda: LR.plan_pieces(
        conts, dense[3], dense[4], dense[0].numel(), dense[2].numel()), 5)
    print(profile_flatten(dec, dense, conts, n_raw), flush=True)
    out, ok = CR.lz_rebuild(**args)
    out_off = np.concatenate(([0], np.cumsum(np.asarray(n_raw, np.int64))))
    kernel_ms = cuda_ms(lambda: CR.lz_rebuild(**args), reps=5, warmup=1)
    split = profile_kernel(args)
    print(f"rebuild kernels, us: {split['kernel_us']}; doubling rounds in "
          f"order: {split['round_us']}; open positions before each round "
          f"and after the last: {split['unresolved']}", flush=True)
    got = out_to_host(out, out_off)
    bad = sum(g != r for g, r in zip(got, raws)) + int((~ok).sum())
    if bad:
        raise RuntimeError(f"device rebuild: {bad} containers differ or "
                           f"fail their checks")
    pinned = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=True)
    direct = _host_ms(lambda: out_to_host(out, out_off), 5)
    staged = _host_ms(lambda: out_to_host(out, out_off, pinned), 5)
    with ThreadPoolExecutor(8) as pool:
        threads = _host_ms(lambda: out_to_host(out, out_off, pinned, pool), 5)
        if out_to_host(out, out_off, pinned, pool) != raws:
            raise RuntimeError("the threaded output copy differs")
    d2h = cuda_ms(lambda: pinned.copy_(out, non_blocking=True), reps=5,
                  warmup=1)
    return {"flatten_ms": flatten_ms, "flatten_first_host_ms": first_ms,
            "plan_host_ms": plan_ms,
            "kernel_ms": kernel_ms, "out_direct_ms": direct,
            "out_pinned_then_copy_ms": staged, "out_pinned_d2h_ms": d2h,
            "out_pinned_then_8_threads_ms": threads, **split,
            "rows": args["rows"].shape[0],
            "literals": args["literals"].numel(), "bytes": out.numel()}


def main(argv=None) -> int:
    from .. import TorchDecoder
    card = require_card("bench_rebuild")
    pairs = serving_pairs()
    dec = TorchDecoder("cuda")
    sources = [c for _, c in pairs]
    raws = [r for r, _ in pairs]
    dec.decode_many(sources)   # warm-up: the captured call is a warm one
    outs, stats, (args, kwargs) = capture(dec, sources)
    bad = sum(hashlib.sha256(o).digest() != hashlib.sha256(r).digest()
              for o, r in zip(outs, raws))
    if bad or stats.get("fallbacks", 0):
        raise RuntimeError(f"{bad} SHA mismatches, "
                           f"{stats.get('fallbacks', 0)} fallbacks")
    real = native_runtime().flatten_rebuild
    times = []
    for _ in range(9):
        t = time.perf_counter()
        status = real(*args, **kwargs)
        times.append(time.perf_counter() - t)
    if (status < 0).any():
        raise RuntimeError("flatten_rebuild reported a failed container")
    total = sum(len(o) for o in outs)
    t = second_smallest(times)
    print(f"rebuild: {total / 1e6:.1f} MB in {t * 1e3:.3f} ms = "
          f"{total / t / 1e9:.3f} GB/s (runs ms: "
          + " ".join(f"{x * 1e3:.2f}" for x in sorted(times))
          + f"); in decode_many: flatten {stats['flatten'] * 1e3:.3f} ms, "
          f"rebuild {stats['rebuild'] * 1e3:.3f} ms", flush=True)
    dev = device_rebuild(dec, sources, raws)
    print(f"device: flatten {dev['flatten_ms']:.3f} ms (events; first call "
          f"{dev['flatten_first_host_ms']:.1f} ms host; its host plan "
          f"{dev['plan_host_ms']:.3f} ms), rebuild kernel "
          f"{dev['kernel_ms']:.3f} ms for {dev['bytes']} bytes, "
          f"{dev['rows']} rows, {dev['literals']} literals; output to host: "
          f"into the bytes objects {dev['out_direct_ms']:.3f} ms, pinned "
          f"then copied {dev['out_pinned_then_copy_ms']:.3f} ms (of which "
          f"the D2H {dev['out_pinned_d2h_ms']:.3f} ms), pinned then 8 "
          f"threads {dev['out_pinned_then_8_threads_ms']:.3f} ms", flush=True)
    print(json.dumps({"card": card, "host_flatten_rebuild_ms": t * 1e3,
                      "decode_many_flatten_ms": stats["flatten"] * 1e3,
                      "decode_many_rebuild_ms": stats["rebuild"] * 1e3,
                      **dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
