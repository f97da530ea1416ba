"""The traced sub-window: ``torch.profiler`` over the card, reduced to what
the per-layer readers and the result line's ``breakdown`` take.

The harness marks the sub-window with the annotation ``benchmark.window``
and each call with ``benchmark.call``; the program itself has no spans.
The profiler's chrome trace is read back from a file in the run's
temporary directory and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "benchmark.window"
TOP = 10
NAME_CHARS = 64
_LOOK_BACK = 4096   # host events searched back for the one covering a gap


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)  # name: [count, seconds]
    device_ops: list = field(default_factory=list)   # [name, seconds]
    idle_gaps: list = field(default_factory=list)    # [name, seconds]

    def kernel_time(self, *names: str) -> tuple[int, float] | None:
        """(instances, seconds) of the kernels whose names contain any of
        ``names`` (fewest instances of any one of them, total seconds), or
        None when one of them never ran."""
        counts, total = [], 0.0
        for part in names:
            hits = [v for k, v in self.kernels.items() if part in k]
            if not hits:
                return None
            counts.append(sum(c for c, _ in hits))
            total += sum(s for _, s in hits)
        return min(counts), total


def _short(name: str) -> str:
    return name.replace(" ", "_")[:NAME_CHARS]


def _merge(spans: list) -> list:
    """Union of (start, end) spans, sorted, overlaps joined."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list) -> Trace | None:
    """Reduce chrome-trace events to a ``Trace``: the ``benchmark.window``
    annotation bounds it; device time is the union of kernel, copy and set
    spans inside it; idle gaps are the spaces between them, each named by
    the host event that was innermost at its middle and the device
    operations on its two sides. None without the window annotation."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e.get("name", "?"), cat))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e.get("name", "?")))
    kernels: dict = {}
    ops: dict = {}
    for a, b, name, cat in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        if cat == "kernel":
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) * 1e-6
    busy = _merge([(a, b) for a, b, _, _ in dev])
    edges = [w0] + [x for span in busy for x in span] + [w1]
    by_end = sorted(dev, key=lambda d: d[1])
    ends = [d[1] for d in by_end]
    by_start = sorted(dev)
    starts = [d[0] for d in by_start]
    host.sort()
    host_starts = [h[0] for h in host]
    gaps: dict = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        doing = "idle"
        # the innermost host event at the gap's middle: the latest start
        # among those that cover it (a bounded look back)
        i = bisect.bisect_right(host_starts, mid) - 1
        for j in range(i, max(i - _LOOK_BACK, -1), -1):
            if host[j][1] >= mid:
                doing = host[j][2]
                break
        i = bisect.bisect_right(ends, g0) - 1
        left = by_end[i][2] if i >= 0 else "start"
        i = bisect.bisect_left(starts, g1)
        right = by_start[i][2] if i < len(by_start) else "end"
        key = _short(f"host_{doing}:{_short(left)[:24]}-{_short(right)[:24]}")
        gaps[key] = gaps.get(key, 0.0) + (g1 - g0) * 1e-6

    def top(d: dict) -> list:
        return [[_short(k), v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])][:TOP]

    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernels=kernels, device_ops=top(ops), idle_gaps=top(gaps))


def profile(fn) -> Trace | None:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity) inside
    the ``benchmark.window`` annotation and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    kw = {}
    try:   # the clients' threads too, where this torch can
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA], **kw) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    return reduce_events(events)
