"""Full decode on the card per corpus kind: one row per kind, each kind
decoded as its own batch.

    python3 -m lzfse_rust_tpu_torch.tools.bench_per_file

Port of the JAX package's ``tools/bench_tpu_per_file.py``. That tool
decoded each Snappy-corpus file replicated to about 24 MB; those files are
not in the repository, so each row here is one kind of
``utils/corpus.KINDS`` (the kinds that stand in for the Snappy files),
seeded, about 24 MiB of raw bytes in containers of 16 KiB to 4 MiB. Per
kind: one warm-up ``TorchDecoder("cuda").decode_many``, then 5 timed runs,
every output SHA-checked against its raw input with no fallback; the wall
and every stage are the second-smallest over the runs. One JSON line per
kind, then a table.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

from ..utils import corpus as CP
from .common import require_card, second_smallest

TARGET_RAW = 24 << 20
RUNS = 5


def main(argv=None) -> int:
    from .. import TorchDecoder
    require_card("bench_per_file")
    dec = TorchDecoder("cuda")
    rows = []
    for k, kind in enumerate(CP.KINDS):
        pairs = CP.kind_batch(kind, seed=k, min_bytes=TARGET_RAW)
        sources = [c for _, c in pairs]
        want = [hashlib.sha256(r).digest() for r, _ in pairs]
        raw = sum(len(r) for r, _ in pairs)
        dec.decode_many(sources)
        walls, stats = [], []
        for _ in range(RUNS):
            st: dict = {}
            t = time.perf_counter()
            outs = dec.decode_many(sources, st)
            walls.append(time.perf_counter() - t)
            stats.append(st)
            bad = sum(hashlib.sha256(o).digest() != w
                      for o, w in zip(outs, want))
            if bad or st.get("fallbacks", 0):
                raise RuntimeError(f"{kind}: {bad} SHA mismatches, "
                                   f"{st.get('fallbacks', 0)} fallbacks")
        wall = second_smallest(walls)
        row = {"kind": kind, "containers": len(pairs), "raw_bytes": raw,
               "compressed_bytes": sum(map(len, sources)),
               "GBps": raw / wall / 1e9, "wall_ms": wall * 1e3,
               "stages_ms": {s: second_smallest([x[s] for x in stats]) * 1e3
                             for s in ("parse", "prep", "device", "flatten",
                                       "rebuild")},
               "detail_device_ms": {
                   s: second_smallest([x["detail_device"][s] for x in stats])
                   for s in stats[0]["detail_device"]}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print("\n| kind | containers | raw MB | ratio | decode GB/s | kernels ms |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['kind']} | {r['containers']} | {r['raw_bytes'] / 1e6:.1f} "
              f"| {r['compressed_bytes'] / r['raw_bytes']:.3f} "
              f"| {r['GBps']:.4f} | {r['detail_device_ms']['kernels_ms']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
