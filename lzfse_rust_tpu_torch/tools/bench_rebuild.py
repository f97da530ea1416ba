"""The host rebuild stage alone: ``native.flatten_rebuild`` with the
arguments ``TorchDecoder.decode_many`` gives it on the serving batch.

    python3 -m lzfse_rust_tpu_torch.tools.bench_rebuild

Port of the JAX package's ``tools/bench_rebuild.py``. After one warm-up,
one ``decode_many`` on the card runs with ``flatten_rebuild`` wrapped so
that its arguments are kept; every output is checked against its raw input
(SHA-256). Then the call alone runs 9 times on those arguments (it writes
the same bytes into the same outputs each time); the second-smallest is
reported. The card is used only to produce the arguments.
"""

from __future__ import annotations

import hashlib
import sys
import time

from ..runtime.build import native_runtime
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


def main(argv=None) -> int:
    from .. import TorchDecoder
    require_card("bench_rebuild")
    pairs = serving_pairs()
    dec = TorchDecoder("cuda")
    sources = [c for _, c in pairs]
    dec.decode_many(sources)   # warm-up: the captured call is a warm one
    outs, stats, (args, kwargs) = capture(dec, sources)
    bad = sum(hashlib.sha256(o).digest() != hashlib.sha256(r).digest()
              for o, (r, _) in zip(outs, pairs))
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
          + f"); in decode_many: rebuild {stats['rebuild'] * 1e3:.3f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
