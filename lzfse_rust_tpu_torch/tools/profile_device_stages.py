"""The device stage of ``TorchDecoder.decode_many`` on ``REPS`` copies of
the serving batch: CUDA events per stage and the profiler's device time
per kernel.

    python3 -m lzfse_rust_tpu_torch.tools.profile_device_stages [REPS]

Port of the JAX package's ``tools/profile_device_stages.py`` (``REPS``
defaults to 1: the seeded serving batch is already the size of the JAX
tool's 48 corpus replicas). One warm-up ``decode_many``, then one run with
``stats``: the wall of every stage, and the upload, kernels and download
in CUDA events (``stats["detail_device"]``). Then one more run under
``torch.profiler``: device time per kernel and copy by name, and the
device's busy share of the ``device`` stage. The last line is one JSON
object.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .common import require_card, serving_pairs


def profile_kernels(fn) -> dict:
    """Device microseconds by event name over one call of ``fn`` under
    ``torch.profiler`` (empty when the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = us
    return out


def main(argv=None) -> int:
    from .. import TorchDecoder
    argv = sys.argv[1:] if argv is None else argv
    require_card("profile_device_stages")
    reps = int(argv[0]) if argv else 1
    pairs = serving_pairs()
    sources = [c for _, c in pairs] * reps
    raw = sum(len(r) for r, _ in pairs) * reps
    dec = TorchDecoder("cuda")
    dec.decode_many(sources)
    stats: dict = {}
    t = time.perf_counter()
    dec.decode_many(sources, stats)
    wall = time.perf_counter() - t
    if stats.get("fallbacks", 0):
        raise RuntimeError(f"{stats['fallbacks']} spec-layer fallbacks")
    det = stats["detail_device"]
    busy = det["upload_ms"] + det["kernels_ms"] + det["download_ms"]
    print(f"batch x{reps}: {len(sources)} containers, {raw} raw bytes, "
          f"decode_many {wall * 1e3:.3f} ms = {raw / wall / 1e9:.4f} GB/s",
          flush=True)
    print("stages ms " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in stats.items()
        if isinstance(v, float)), flush=True)
    print("device events ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in det.items())
        + f"; device busy {busy:.3f} of {wall * 1e3:.3f} ms wall "
        f"(idle share {1 - busy / (wall * 1e3):.3f})", flush=True)
    kernels = profile_kernels(lambda: dec.decode_many(sources))
    if kernels:
        for name, us in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print(f"  profiler {us / 1e3:9.3f} ms  {name}", flush=True)
    else:
        print("  profiler: no device time recorded", flush=True)
    print(json.dumps({
        "reps": reps, "raw_bytes": raw, "wall_ms": wall * 1e3,
        "stages_ms": {k: v * 1e3 for k, v in stats.items()
                      if isinstance(v, float)},
        "detail_device_ms": det,
        "profiler_device_ms": {k: v / 1e3 for k, v in kernels.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
