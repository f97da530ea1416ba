"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the plain reference, and the result line.

``run_cell`` does all of it and returns the result as a dict, with the
lines to print before it; ``run.py`` is its command line. The clients
are closed loops on host threads, one engine of the program each: a
client sends its next call when the last has returned. The window's
rate is every byte of every call that completed in it over the seconds
from its start to its last completion.
"""

from __future__ import annotations

import concurrent.futures as cf
import gc
import multiprocessing as mp
import os
import statistics
import sys
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from . import corpus, registry
from . import trace as TR
from .ops import OPS

# a client keeps the outputs of one of its first KEEP_WITHIN calls (drawn
# from the seed) for the check after the window, and drops every other
# call's outputs once it is checked
KEEP_WITHIN = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "lzfse_rust_tpu")


@dataclass
class Call:
    client: int
    index: int
    t0: float
    t1: float
    nbytes: int
    stats: dict
    error: str | None = None


@dataclass
class Window:
    t_start: float
    t_end: float
    calls: list = field(default_factory=list)   # every call, by start
    kept: list = field(default_factory=list)    # outputs kept to judge
    faults: dict = field(default_factory=dict)  # summed quick checks

    def done(self) -> list:
        """The calls that completed inside the window without raising."""
        return [c for c in self.calls
                if c.error is None and c.t1 <= self.t_end]


def window_rate(calls, t_start: float, t_end: float) -> float | None:
    """GB/s: the bytes of every call that completed by ``t_end`` without
    raising, over the seconds from ``t_start`` to the last of those
    completions; None when none did."""
    done = [c for c in calls if c.error is None and c.t1 <= t_end]
    if not done:
        return None
    span = max(c.t1 for c in done) - t_start
    return sum(c.nbytes for c in done) / span / 1e9


def percentile(xs, q: int) -> float | None:
    """The ``q``-th percentile (``statistics.quantiles``, inclusive)."""
    xs = list(xs)
    if len(xs) < 2:
        return xs[0] if xs else None
    return statistics.quantiles(xs, n=100, method="inclusive")[q - 1]


@dataclass
class Run:
    """What one run measured: the per-layer readers' input."""
    cell: registry.Cell
    op: object
    setup_s: float
    window: Window
    trace: TR.Trace | None = None
    _work: dict | None = None

    @property
    def op_name(self) -> str:
        return self.cell.traffic["op"]

    def calls(self) -> list:
        return self.window.done()

    def rate_GBps(self) -> float | None:
        w = self.window
        return window_rate(w.calls, w.t_start, w.t_end)

    def mean_stat(self, *keys: str, scale: float = 1e3) -> float | None:
        """Mean over the window's calls of the sum of ``stats`` keys (host
        seconds), times ``scale``; None when a key is missing."""
        calls = self.calls()
        if not calls or any(k not in c.stats for c in calls for k in keys):
            return None
        return statistics.fmean(sum(c.stats[k] for k in keys)
                                for c in calls) * scale

    def mean_device_ms(self, *keys: str) -> float | None:
        """Mean over the window's calls of the sum of
        ``stats["detail_device"]`` keys (CUDA-event ms)."""
        calls = self.calls()
        dets = [c.stats.get("detail_device", {}) for c in calls]
        if not dets or any(k not in d for d in dets for k in keys):
            return None
        return statistics.fmean(sum(d[k] for k in keys) for d in dets)

    def work(self) -> dict:
        """One call's FSE work, counted from its containers by the plain
        reference: the inputs of a decode, the outputs of an encode."""
        if self._work is None:
            from .reference.check import fse_work
            conts = self.op.batch if self.op_name == "decode" else \
                self.op.first
            self._work = fse_work(conts)
        return self._work


def _merge_faults(into: dict, more: dict) -> None:
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


def run_window(op, engines, seconds: float, seed: int,
               annotate: bool = False, keep: bool = True) -> Window:
    """Closed loops of ``len(engines)`` clients for ``seconds``: each sends
    its next call while the window is open. Calls that complete after it
    closes are waited for and checked, and leave the rate out."""
    n = len(engines)
    start = threading.Barrier(n + 1)
    box: dict = {}
    per_client: list = [[] for _ in range(n)]
    kept: list = [[] for _ in range(n)]
    faults: list = [{} for _ in range(n)]
    keep_at = [int(np.random.default_rng([corpus.seed_key(seed), 17, c])
                   .integers(KEEP_WITHIN))
               for c in range(n)]

    def client(c: int) -> None:
        if annotate:
            from torch.profiler import record_function
        start.wait()
        t_end = box["t_end"]
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            stats: dict = {}
            err = outs = None
            try:
                with (record_function("benchmark.call") if annotate
                      else nullcontext()):
                    outs = op.call(engines[c], stats)
            except Exception as exc:   # a failed call is counted, not fatal
                err = f"{type(exc).__name__}: {exc}"
            t1 = time.perf_counter()
            per_client[c].append(Call(c, i, t0, t1, op.nbytes, stats, err))
            if outs is not None:
                _merge_faults(faults[c], op.quick(outs, stats, (c, i)))
                if keep and (i == keep_at[c] or i < keep_at[c]
                             and t1 >= t_end):
                    kept[c].append(outs)
            outs = None   # dropped before the next call, as a service would
            i += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    box["t_end"] = t_start + seconds
    start.wait()
    for t in threads:
        t.join()
    w = Window(t_start, box["t_end"])
    w.calls = sorted((c for cs in per_client for c in cs),
                     key=lambda c: c.t0)
    w.kept = [o for ks in kept for o in ks]
    for f in faults:
        _merge_faults(w.faults, f)
    return w


def _parallel(fns) -> list:
    """Run the callables at once on threads; return their results."""
    out: list = [None] * len(fns)
    errs: list = []

    def go(i):
        try:
            out[i] = fns[i]()
        except Exception as exc:
            errs.append(exc)

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return out


class Inputs:
    """The raw inputs of a configuration, made from the seed in worker
    processes (``corpus.make_file``, one task a file, the largest first)
    from construction on: making them overlaps the imports without taking
    the interpreter lock from them. ``result()`` waits for every file and
    for the workers to end; ``seconds`` is then the making's own time."""

    def __init__(self, config: dict, seed: int):
        self._t0 = time.perf_counter()
        self._last = self._t0
        self.seconds = 0.0
        files = corpus.layout(config)
        self._n = len(files)
        self._ex = cf.ProcessPoolExecutor(
            min(os.cpu_count() or 1, 8, max(self._n, 1)),
            mp_context=mp.get_context("spawn"))
        order = sorted(range(self._n), key=lambda i: -files[i][2])
        self._futs = []
        for i in order:
            fut = self._ex.submit(corpus.make_file, files[i][1], files[i][2],
                                  seed, i)
            fut.add_done_callback(self._done)
            self._futs.append((i, fut))

    def _done(self, fut) -> None:
        self._last = max(self._last, time.perf_counter())

    def result(self) -> list[bytes]:
        out: list = [None] * self._n
        try:
            for i, fut in self._futs:
                out[i] = fut.result()
        finally:
            self.close()
        self.seconds = self._last - self._t0
        return out

    def close(self) -> None:
        """Stop the workers (pending files are dropped) and wait for them."""
        self._ex.shutdown(wait=True, cancel_futures=True)


def _faults() -> tuple[int, int]:
    """This process's minor and major page faults (``/proc/self/stat``;
    -1 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            rest = f.read().rsplit(")", 1)[1].split()
        return int(rest[7]), int(rest[9])
    except (OSError, ValueError, IndexError):
        return -1, -1


def host_sample() -> dict:
    """This process's CPU seconds and page faults so far, read at the
    window's start and end for the ``host`` line."""
    t = os.times()
    minflt, majflt = _faults()
    return {"wall_s": time.perf_counter(), "utime_s": t.user,
            "stime_s": t.system, "minflt": minflt, "majflt": majflt}


def cpu_probe_ms() -> float:
    """Milliseconds of a fixed piece of single-threaded interpreter work:
    how fast the host runs one thread right now."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return (time.perf_counter() - t0) * 1e3


def host_line(a: dict, b: dict) -> str:
    """The window's host readings, from samples ``a`` to ``b``: what the
    host gave this process (CPU seconds in user and system mode, page
    faults)."""
    return "host " + " ".join(
        f"{k}={b[k] - a[k]:.3f}" if k.endswith("_s") else f"{k}={b[k] - a[k]}"
        for k in a)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    relatives' or the JAX package's (whole names compared)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             root=registry.ROOT, bench=registry.BENCH,
             wrap=None, inputs: Inputs | None = None
             ) -> tuple[dict, list[str]]:
    """One run of cell ``name``. Returns (result, lines): the result
    line's object and the lines to print before it. ``inputs``: the raw
    inputs already being made (``Inputs``), so that their making overlaps
    the imports. The caller looks for ``forbidden_modules()`` once this
    has returned: the check and the readers load modules too. ``wrap(op)``, for the tests, may replace the op's calls
    by faulty ones; ``device="cpu"`` runs the program's plain versions (the
    tests' path, without a card)."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = registry.cell(name, root, bench)
    mix = cell.traffic
    cuda = device.startswith("cuda")
    lines: list[str] = []
    split: dict = {}

    def lap(key: str, t: float) -> float:
        now = time.perf_counter()
        split[key] = now - t
        return now

    t = lap("imports", t_process)
    gen = inputs or Inputs(cell.config, seed)
    import torch
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    t = lap("cuda_init", t)
    from lzfse_rust_tpu_torch.runtime.build import native_runtime
    native_runtime()
    if cuda:
        from lzfse_rust_tpu_torch.runtime import cuda_lib
        cuda_lib.lib()
    t = lap("kernel_load", t)
    raws = gen.result()
    split["input_gen_own"] = gen.seconds
    t = lap("input_gen", t)
    op = OPS[mix["op"]](raws, seed, mix)
    op.prepare()
    t = lap("container_encode", t)
    if wrap is not None:
        op = wrap(op)
    engines = [op.engine(device) for _ in range(int(mix["clients"]))]
    t = lap("engines", t)
    warm_faults: dict = {}

    def warm(c):
        stats: dict = {}
        outs = op.call(engines[c], stats)
        return outs, op.quick(outs, stats, (c, -1))

    warmed = _parallel([lambda c=c: warm(c) for c in range(len(engines))])
    for _, f in warmed:
        _merge_faults(warm_faults, f)
    if hasattr(op, "warmed"):
        op.warmed(warmed[0][0])
    del warmed
    if cuda:
        torch.cuda.synchronize()
    t = lap("warm_up", t)
    setup_s = t - t_process
    lines.append("setup_split_s " + " ".join(
        f"{k}={v:.3f}" for k, v in split.items()) + f" total={setup_s:.3f}")

    before = host_sample()
    window = run_window(op, engines, seconds, seed)
    lines.append(host_line(before, host_sample())
                 + f" probe_ms={cpu_probe_ms():.3f}")
    run = Run(cell, op, setup_s, window)
    mid = (window.t_start + window.t_end) / 2
    halves = [sum(c.nbytes for c in window.done() if (c.t1 <= mid) == first)
              / (mid - window.t_start) / 1e9 for first in (True, False)]
    lines.append(f"window calls={len(window.done())} "
                 f"halves_GBps={halves[0]:.4f},{halves[1]:.4f}")
    faults = dict(window.faults)
    _merge_faults(faults, warm_faults)
    if trace:
        walls = {}
        for c in window.done():
            walls.setdefault(c.client, []).append(round((c.t1 - c.t0) * 1e3, 3))
        for c, ws in sorted(walls.items()):
            lines.append(f"walls_ms client {c}: {ws}")
        sub = float(mix.get("trace_seconds", 2.0))
        box = {}

        def traced():
            box["w"] = run_window(op, engines, sub, seed, annotate=True,
                                  keep=False)

        run.trace = TR.profile(traced) if cuda else None
        if "w" in box:
            _merge_faults(faults, box["w"].faults)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(
               torch.cuda.max_memory_allocated(d)
               for d in range(cell.chips))) if cuda else 0}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    engines.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program's state is freed
    t = time.perf_counter()
    verdict = op.judge(window.kept, np.random.default_rng([
        corpus.seed_key(seed), 99]))
    lines.append(f"reference_check_s {time.perf_counter() - t:.3f}")
    failed = sum(c.error is not None for c in window.calls)
    checks = {"failed_calls": failed, **faults, **verdict}
    limits = {k: 0 for k in checks}
    errors = sorted({c.error for c in window.calls if c.error})
    for e in errors[:3]:
        lines.append(f"call error: {e}")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(m)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {"correct": all(checks[k] <= limits[k] for k in checks),
              "attempted": len(window.calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in checks}
    return result, lines
