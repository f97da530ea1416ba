"""The calling thread's CPU in each stage of a program call, from its
``stats["detail_cpu"]`` (a ``{"user": s, "sys": s}`` a stage, beside the
stage's wall seconds in ``stats[stage]``): what the readers of a stage's
waiting and system time take, and the sum that ``cpu_account.py`` sets
against the process's CPU. A program without the span recorder writes no
``detail_cpu``; every function then gives None."""

from __future__ import annotations

import statistics


def mean_ms(run, keys: tuple, part) -> float | None:
    """Mean over the window's decode calls of ``part(wall_s, user_s,
    sys_s)`` summed over the stages ``keys``, in milliseconds; None for
    another op, without calls, or when a call lacks ``detail_cpu`` or one
    of the stages."""
    if run.op_name != "decode":
        return None
    calls = run.calls()
    if not calls:
        return None
    per_call = []
    for c in calls:
        cpu = c.stats.get("detail_cpu")
        if cpu is None or any(k not in cpu or k not in c.stats for k in keys):
            return None
        per_call.append(sum(part(c.stats[k], cpu[k]["user"], cpu[k]["sys"])
                            for k in keys))
    return statistics.fmean(per_call) * 1e3


def call_cpu_s(stats: dict) -> float | None:
    """The calling thread's CPU seconds (user and system) over every stage
    of one call; None without ``detail_cpu``."""
    cpu = stats.get("detail_cpu")
    if cpu is None:
        return None
    return sum(v["user"] + v["sys"] for k, v in cpu.items()
               if not k.startswith("detail_"))
