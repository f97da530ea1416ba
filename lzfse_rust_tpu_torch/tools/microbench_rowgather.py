"""Row-gather cost against row layout on the card: the match finder's
gather of forward byte windows.

    python3 -m lzfse_rust_tpu_torch.tools.microbench_rowgather

Port of the JAX package's ``tools/microbench_rowgather.py``. The same
layouts of the grouped match finder's window matrix, ``(N, 64)`` uint8
and ``(N, 16)`` / ``(N, 32)`` / ``(N, 128)`` int32 with N = 2**20 rows,
each gathered by 2**20 random int64 row indices (``index_select``; the
``(N, 16)`` layout also by 2**18 and 2**22), then
the plain version's ``_windows_fwd`` build of a 1 MiB window and its whole
``_grouped_core`` (the gather, four rolls and first-mismatch LCPs) on
that window with the host's grouping (``native.match_group``).

Each case is timed twice: the mean of ``REPS`` calls between CUDA events
after a warm-up call (the JAX tool needed a data dependency between in-jit
repetitions; events need none), and the device time per call of the
kernels that ``torch.profiler`` records over ``REPS`` more calls, with
their names, which shows what the events time. A gather also gets its
rows per microsecond, its bytes (each index read, each row read once and
written once) and the time those bytes take at the card's memory rate
(``bound_ms``), so a time that does not move with the bytes shows as a
growing distance from that bound. One line per case, then one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..utils.timing import cuda_ms
from .common import require_card

N = 1 << 20
REPS = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM5 HBM3
LAYOUTS = (("(1M,64) u8", 64, torch.uint8), ("(1M,16) i32", 16, torch.int32),
           ("(1M,32) i32", 32, torch.int32),
           ("(1M,128) i32", 128, torch.int32))


def gather_bytes(width: int, dtype: torch.dtype, n_idx: int = N) -> int:
    """Bytes one gather moves: the int64 indices read, each row read once
    and written once."""
    return n_idx * 8 + 2 * n_idx * width * dtype.itemsize


def kernel_ms(fn, reps: int = REPS) -> dict:
    """Device milliseconds per call of each kernel that ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls: kernel name -> ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        # the profiler's own buffer request is no kernel of fn
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("Activity Buffer")):
            out[e.name] = (out.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / reps)
    return out


def main(argv=None) -> int:
    from ..ops import match_find as MF
    from ..runtime.build import native_runtime
    require_card("microbench_rowgather")
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, N, N, dtype=np.int64)).cuda()
    rows = {}
    for name, width, dtype in LAYOUTS:
        info = np.iinfo(np.uint8 if dtype == torch.uint8 else np.int32)
        arr = torch.from_numpy(rng.integers(0, info.max, (N, width))
                               .astype(info.dtype)).cuda()

        def gather():
            return arr.index_select(0, idx)

        n_bytes = gather_bytes(width, dtype)
        ms = cuda_ms(gather, reps=REPS)
        rows[f"take {name}"] = {
            "ms": ms, "kernels_ms": kernel_ms(gather), "bytes": n_bytes,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "rows_per_us": N / (ms * 1e3)}
        if width == 16:
            # a quarter and four times the indices: a gather whose time
            # follows the row count and not the bytes scales with these
            for n_idx in (N >> 2, N << 2):
                sub = torch.from_numpy(rng.integers(0, N, n_idx,
                                                    dtype=np.int64)).cuda()

                def gather_n(sub=sub):
                    return arr.index_select(0, sub)

                n_bytes = gather_bytes(width, dtype, n_idx)
                ms = cuda_ms(gather_n, reps=REPS)
                rows[f"take {name} x{n_idx >> 10}K idx"] = {
                    "ms": ms, "kernels_ms": kernel_ms(gather_n),
                    "bytes": n_bytes,
                    "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                    "rows_per_us": n_idx / (ms * 1e3)}
    src = rng.integers(0, 255, N, dtype=np.uint8)
    src_d = torch.from_numpy(src).cuda()

    def build():
        return MF._windows_fwd(src_d).contiguous()

    rows["_windows_fwd build"] = {"ms": cuda_ms(build, reps=REPS),
                                  "kernels_ms": kernel_ms(build)}
    order, ok = native_runtime().match_group(src, N - 128, False)
    order_d = torch.from_numpy(order).cuda()
    ok_d = torch.from_numpy(ok).cuda()
    n_real = torch.tensor(N - 128, dtype=torch.int32, device="cuda")

    def core():
        return MF._grouped_core(src_d, n_real, order_d, ok_d)

    rows["_grouped_core full"] = {"ms": cuda_ms(core, reps=3),
                                  "kernels_ms": kernel_ms(core, reps=3)}
    for name, r in rows.items():
        total = sum(r["kernels_ms"].values())
        top = max(r["kernels_ms"], key=r["kernels_ms"].get)
        line = (f"{name:28s} events {r['ms']:9.4f} ms, kernels "
                f"{total:9.4f} ms ({len(r['kernels_ms'])} kinds; most: "
                f"{top[:48]})")
        if "bound_ms" in r:
            line += (f", {r['rows_per_us']:.1f} rows/us, "
                     f"{r['bytes'] / 1e6:.0f} MB, bound "
                     f"{r['bound_ms']:.4f} ms")
        print(line, flush=True)
    print(json.dumps({"rows": N, "indices": N, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
