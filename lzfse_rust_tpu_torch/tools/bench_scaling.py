"""Strong scaling of the mesh decode: the serving batch over 1, 2 and 4
shards.

    python3 -m lzfse_rust_tpu_torch.tools.bench_scaling

Port of the JAX package's ``tools/bench_scaling.py``. For each shard count
``TorchDecoder("cuda", mesh=...)`` decodes the seeded serving batch once to
warm up, then ``REPS`` times, each output SHA-checked against its raw
input. The mesh takes the CUDA devices in turn, so with fewer cards than
shards a card holds several shards (``cuda:0`` four times on one card):
they share its SMs and its copy engines, and the table then measures the
cost of sharding, not a speed-up. Per shard count: the wall time of
``decode_many`` (the second smallest of the runs), each shard's kernel
milliseconds (CUDA events, the literal and L/M/D kernels of that shard, in
the timed run with the smallest wall time, with that run's stage split),
the kernels' span, and the gather: the download of every shard's outputs
into one host buffer in batch order (CUDA events). The JAX tool's extrapolation to TPU links is not
carried over. Prints a JSON line per shard count and a table.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import torch

from .common import require_card, second_smallest, serving_pairs

SHARDS = (1, 2, 4)
REPS = 7


def measure(dec, pairs) -> dict:
    """One warm-up ``decode_many``, then ``REPS`` timed ones (each output
    checked); the wall seconds and the device split of the fastest."""
    sources = [c for _, c in pairs]
    want = [hashlib.sha256(r).digest() for r, _ in pairs]
    dec.decode_many(sources)
    runs = []
    for _ in range(REPS):
        stats: dict = {}
        t = time.perf_counter()
        outs = dec.decode_many(sources, stats)
        wall = time.perf_counter() - t
        if [hashlib.sha256(o).digest() for o in outs] != want \
                or stats.get("fallbacks", 0):
            raise RuntimeError("bench_scaling: a decode differs from its raw "
                               "input or fell back")
        runs.append((wall, stats))
    walls = [w for w, _ in runs]
    fast = min(runs, key=lambda r: r[0])[1]
    det = fast["detail_device"]
    return {"wall_s": second_smallest(walls), "walls_s": walls,
            "split_ms": {k: v * 1e3 for k, v in fast.items()
                         if isinstance(v, float)},
            "kernels_ms": det["kernels_ms"],
            "shard_kernels_ms": det["shard_kernels_ms"],
            "gather_ms": det["download_ms"], "upload_ms": det["upload_ms"]}


def main(argv=None) -> int:
    del argv
    require_card("bench_scaling")
    from ..models.decoder import TorchDecoder
    from ..parallel.dryrun import mesh_devices
    from ..parallel.mesh import make_mesh
    pairs = serving_pairs()
    raw = sum(len(r) for r, _ in pairs)
    n_cards = torch.cuda.device_count()
    print(f"{n_cards} CUDA device(s); "
          + ("shards beyond the cards share them: this measures the cost of "
             "sharding, not a speed-up" if n_cards < max(SHARDS) else
             "one card a shard"), flush=True)
    rows = {}
    for n in SHARDS:
        devs = mesh_devices(n, "cuda")
        row = measure(TorchDecoder("cuda", mesh=make_mesh(devs)), pairs)
        row.update(shards=n, devices=[str(d) for d in devs],
                   GBps=raw / row["wall_s"] / 1e9)
        rows[n] = row
        print(json.dumps(row), flush=True)
    print("\n| shards | devices | wall ms | GB/s | kernels ms (span) | "
          "per-shard kernel ms | gather ms |")
    print("|---|---|---|---|---|---|---|")
    for n, r in rows.items():
        print(f"| {n} | {', '.join(r['devices'])} | {r['wall_s'] * 1e3:.3f} "
              f"| {r['GBps']:.4f} | {r['kernels_ms']:.4f} | "
              f"{', '.join(f'{x:.4f}' for x in r['shard_kernels_ms'])} | "
              f"{r['gather_ms']:.4f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
