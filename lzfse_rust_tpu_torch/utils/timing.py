"""Timing: device time with CUDA events, and the engines' span recorder.

``cuda_ms`` is the counterpart of ``lzfse_rust_tpu/utils/timing.py``.
PyTorch returns before the card finishes, so a host clock around a launch
measures the enqueue; events recorded on the stream around a run of
launches measure the card. ``_Clock`` records the host stages of one
``decode_many`` or ``encode_many`` call (``models/decoder.py``,
``models/encoder.py``).
"""

from __future__ import annotations

import resource
import time
from typing import Callable

import torch


def cuda_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA stream: ``warmup``
    untimed calls, then ``reps`` calls between two events."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _thread_cpu() -> tuple[float, float]:
    """The calling thread's CPU seconds so far (``CLOCK_THREAD_CPUTIME_ID``)
    and its system seconds as the kernel splits them off by tick samples
    (``getrusage(RUSAGE_THREAD)``, which may lag a tick behind)."""
    return (time.thread_time(),
            resource.getrusage(resource.RUSAGE_THREAD).ru_stime)


class _Clock:
    """The port's span recorder: one a ``decode_many`` / ``encode_many``
    call, on the calling thread. A stage runs from the last ``mark`` (or
    the recorder's start) to ``mark(key)``, which closes it under ``key``:

    - its wall seconds are added to ``stats[key]``;
    - the calling thread's CPU seconds in it, user and system, to
      ``stats["detail_cpu"][key]``, a ``{"user": s, "sys": s}``. Their sum
      is the thread's CPU clock: exact on a Linux host, a sample where the
      clock steps by scheduler ticks (10 ms on the benchmark's card
      machine), right then only as a mean over many calls. The system
      share is the kernel's tick-sampled one, capped at the stage's CPU
      seconds, what is over carried into the next stage (the kernel's
      count lags). The other threads of a native stage are not counted,
      so wall less CPU is the time the calling thread spent off a CPU:
      waiting for the interpreter lock, a core, a page, or the join on a
      native stage's slowest worker;
    - under an active ``torch.profiler`` session, a recorder with a
      ``name`` keeps one profiler range ``lzfse.<name>_many`` open while
      it is entered (``with``) and one ``lzfse.<name>.<stage>`` from
      ``begin(key)`` to the stage's mark, on the profiler's clock; a
      ``prep_x`` stage's range is ``prep.x``.

    With ``stats`` None no clock or CPU time is read; with no profiler
    session no profiler function is called (one check a call). The
    decoder's device side is its ``_add_ms`` / ``_add_device_ms`` (CUDA
    events)."""

    def __init__(self, stats: dict | None, name: str | None = None):
        self.stats = stats
        self.name = name
        prof = torch.autograd.profiler
        self._rf = (prof.record_function if name and getattr(
            prof, "_is_profiler_enabled", False) else None)
        self._call = self._stage = None   # the open profiler ranges
        if stats is not None:
            self.t = time.perf_counter()
            self.cpu, self.sys = _thread_cpu()

    def _range(self, label: str):
        rng = self._rf(label)
        rng.__enter__()
        return rng

    def _close_stage(self) -> None:
        if self._stage is not None:
            self._stage.__exit__(None, None, None)
            self._stage = None

    def __enter__(self) -> "_Clock":
        if self._rf is not None:
            self._call = self._range(f"lzfse.{self.name}_many")
        return self

    def __exit__(self, *exc) -> None:
        self._close_stage()
        if self._call is not None:
            self._call.__exit__(None, None, None)
            self._call = None

    def begin(self, key: str) -> None:
        """Stage ``key`` starts here: opens its profiler range inside the
        call's (closing the last stage's, if still open)."""
        if self._call is not None:
            self._close_stage()
            self._stage = self._range(f"lzfse.{self.name}."
                                      + key.replace("prep_", "prep.", 1))

    def mark(self, key: str) -> float:
        """Close the stage since the last mark under ``key``: its wall and
        CPU seconds into ``stats``, its range closed. Returns its wall
        seconds (0.0 without ``stats``)."""
        self._close_stage()
        if self.stats is None:
            return 0.0
        t = time.perf_counter()
        cpu_t, sys_t = _thread_cpu()
        dt, used = t - self.t, cpu_t - self.cpu
        sys_ = min(max(sys_t - self.sys, 0.0), used)
        self.stats[key] = self.stats.get(key, 0.0) + dt
        cpu = self.stats.setdefault("detail_cpu", {}).setdefault(
            key, {"user": 0.0, "sys": 0.0})
        cpu["user"] += used - sys_
        cpu["sys"] += sys_
        self.t, self.cpu = t, cpu_t
        self.sys += sys_
        return dt

    def fold(self, parent: str) -> None:
        """Sum the stages ``<parent>_*`` into ``parent``, wall and CPU
        alike, each split kept under ``detail_<parent>``."""
        if self.stats is None:
            return
        st = self.stats
        det = {k: st.pop(k) for k in list(st) if k.startswith(parent + "_")}
        st[parent] = st.get(parent, 0.0) + sum(det.values())
        st["detail_" + parent] = det
        cpu = st.setdefault("detail_cpu", {})
        det = {k: cpu.pop(k) for k in list(cpu) if k.startswith(parent + "_")}
        tot = cpu.setdefault(parent, {"user": 0.0, "sys": 0.0})
        for d in det.values():
            tot["user"] += d["user"]
            tot["sys"] += d["sys"]
        cpu["detail_" + parent] = det
