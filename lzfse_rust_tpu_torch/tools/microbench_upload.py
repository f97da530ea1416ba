"""Host-to-device copy of the decode staging buffer, whole and split.

    python3 -m lzfse_rust_tpu_torch.tools.microbench_upload

Port of the JAX package's ``tools/microbench_upload.py``, which split the
upload over host threads. Here the buffer is the pinned staging buffer
that ``TorchDecoder`` fills for the seeded serving batch, and the copy is
split into k contiguous slices on k CUDA streams (k = 1, 2, 4, 6, 8), all
issued from one thread: the copies are asynchronous, so streams and not
threads are what can overlap them. Each k is timed with CUDA events from
before the first copy to after the last; the second-smallest of 5 runs is
reported.
"""

from __future__ import annotations

import sys

import torch

from .bench_stage_split import upload_source
from .common import decode_inputs, require_card, second_smallest

SPLITS = (1, 2, 4, 6, 8)


def split_copy_ms(host: torch.Tensor, dst: torch.Tensor, streams) -> float:
    """One copy of ``host`` into ``dst``, split over ``streams``."""
    main = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(main)
    n, k = host.numel(), len(streams)
    for i, s in enumerate(streams):
        a, b = n * i // k, n * (i + 1) // k
        s.wait_event(start)
        with torch.cuda.stream(s):
            dst[a:b].copy_(host[a:b], non_blocking=True)
        done = torch.cuda.Event()
        done.record(s)
        main.wait_event(done)
    end.record(main)
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    require_card("microbench_upload")
    dec, _, lit, _, _ = decode_inputs()
    host = upload_source(dec, lit)
    if not host.is_pinned():
        raise RuntimeError("the staging buffer is not pinned")
    dst = torch.empty_like(host, device="cuda")
    streams = [torch.cuda.Stream() for _ in range(max(SPLITS))]
    nbytes = host.numel() * 4
    print(f"staging buffer: {nbytes} bytes, pinned", flush=True)
    for k in SPLITS:
        split_copy_ms(host, dst, streams[:k])
        ms = second_smallest([split_copy_ms(host, dst, streams[:k])
                              for _ in range(5)])
        print(f"k={k}: {ms:8.3f} ms  {nbytes / ms / 1e6:6.2f} GB/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
