"""A kernel's share of its roofline, and the device's idle share, from a
``trace.Trace``. The peaks are ``peaks.json``'s."""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).with_name("peaks.json"))
                   .read_text())


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time one call's work can take on the card: the larger of
    its bytes over the memory rate and its operations over the 32-bit
    operation rate."""
    return max(nbytes / PEAKS["memory_bytes_per_s"],
               ops / PEAKS["int32_ops_per_s"])


def share(trace, kernels, nbytes: float, ops: float) -> float | None:
    """100 times one call's least time over the mean device time per call
    of ``kernels`` (every kernel once a call; the calls are the fewest
    instances of any of them). None when one of them never ran."""
    got = trace.kernel_time(*kernels)
    if got is None or got[0] == 0 or got[1] <= 0:
        return None
    calls, seconds = got
    return 100.0 * least_seconds(nbytes, ops) * calls / seconds


def idle_share(trace) -> float | None:
    """100 times the share of the traced window with nothing on the card."""
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
