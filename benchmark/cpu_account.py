"""One run of a cell as ``run.py`` makes it, with the calling threads' CPU
set against the process's printed before the result line:

    python3 benchmark/cpu_account.py --workload snappy.decode --seed 7 \
        --seconds 50 --trace 1

The line ``cpu_account calls=<n> recorded=<n> calling_cpu_s=<s>
process_cpu_s=<s> share=<x> clock_step_ms=<t> bounds_bad=<k>
bounds_bad_step=<k> stage_cpu_over_wall=<x>@<stage> window_GBps=<r>
traced_GBps=<r>`` holds: the calls of the measured window and how many
carry ``stats["detail_cpu"]``; the sum over them of the calling thread's
user and system CPU over every stage; the process's user and system
seconds over the same span (the ``host`` line's ``utime_s + stime_s``),
which the first can never pass; their ratio; the step in which the thread
CPU clock advances here; the count of stages, in the measured and the
traced window, where ``0 <= sys <= user + sys <= wall + slack`` fails,
with a slack of 2 ms and of one clock step and 2 ms (a clock that steps by
ticks charges a whole tick to a stage it struck); the largest ratio over
the stages of their CPU summed over the window's calls to their wall so
summed; and the rate of each window (with ``--trace 1`` the second is the
profiled sub-window's). Not a metric: a check of the span recorder for
``PERF.md``.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLACK_S = 2e-3


def stages(stats: dict) -> list:
    """(stage, ``{"user", "sys"}``, wall seconds or None) of one call, the
    folded stages and ``detail_prep``'s split alike."""
    cpu = stats.get("detail_cpu", {})
    out = [(k, v, stats.get(k)) for k, v in cpu.items()
           if not k.startswith("detail_")]
    out += [(k, v, stats.get("detail_prep", {}).get(k))
            for k, v in cpu.get("detail_prep", {}).items()]
    return out


def bounds_bad(stats: dict, slack: float = SLACK_S) -> int:
    """Stages of one call whose CPU breaks ``0 <= sys <= user + sys <=
    wall + slack``."""
    return sum(wall is None or not 0 <= c["sys"] <= c["user"] + c["sys"]
               <= wall + slack for _, c, wall in stages(stats))


def clock_step_s(tries: int = 3) -> float:
    """The largest of ``tries`` steps in which this thread's CPU clock
    (``time.thread_time``) advances while it spins."""
    steps = []
    for _ in range(tries):
        a = time.thread_time()
        while (b := time.thread_time()) == a:
            pass
        steps.append(b - a)
    return max(steps)


def account(windows: list, before: dict, after: dict,
            step: float) -> str:
    """The ``cpu_account`` line: the first of ``windows`` is the measured
    one, which the host samples ``before`` and ``after`` enclose; a second
    is the traced sub-window. ``step``: the clock's step (``clock_step_s``)."""
    from benchmark.harness import window_rate
    from benchmark.thread_cpu import call_cpu_s
    w = windows[0]
    used = [call_cpu_s(c.stats) for c in w.calls]
    calling = sum(u for u in used if u is not None)
    process = (after["utime_s"] - before["utime_s"]
               + after["stime_s"] - before["stime_s"])
    calls = [c for x in windows for c in x.calls]
    sums: dict = {}
    for c in w.calls:
        for k, v, wall in stages(c.stats):
            cw = sums.setdefault(k, [0.0, 0.0])
            cw[0] += v["user"] + v["sys"]
            cw[1] += wall or 0.0
    ratio, at = max(((cw[0] / cw[1], k) for k, cw in sums.items()
                     if cw[1] > 0), default=(0.0, "-"))
    rates = " ".join(f"{k}_GBps={window_rate(x.calls, x.t_start, x.t_end)}"
                     for k, x in zip(("window", "traced"), windows))
    return (f"cpu_account calls={len(w.calls)} "
            f"recorded={sum(u is not None for u in used)} "
            f"calling_cpu_s={calling:.3f} process_cpu_s={process:.3f} "
            f"share={calling / process if process else 0:.4f} "
            f"clock_step_ms={step * 1e3:.3f} "
            f"bounds_bad={sum(bounds_bad(c.stats) for c in calls)} "
            f"bounds_bad_step="
            f"{sum(bounds_bad(c.stats, step + SLACK_S) for c in calls)} "
            f"stage_cpu_over_wall={ratio:.4f}@{at} {rates}")


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, run
    windows, samples = [], []
    run_window, host_sample, run_cell = (harness.run_window,
                                         harness.host_sample,
                                         harness.run_cell)

    def keep_window(*a, **k):
        windows.append(run_window(*a, **k))
        return windows[-1]

    def keep_sample():
        samples.append(host_sample())
        return samples[-1]

    def with_account(*a, **k):
        result, lines = run_cell(*a, **k)
        lines.append(account(windows, samples[0], samples[1],
                             clock_step_s()))
        return result, lines

    harness.run_window = keep_window
    harness.host_sample = keep_sample
    harness.run_cell = with_account
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
