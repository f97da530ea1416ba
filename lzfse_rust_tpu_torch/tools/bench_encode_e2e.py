"""End-to-end encode on the card: ``TorchEncoder.encode_many`` over the
serving batch's raw inputs, with its stage split.

    python3 -m lzfse_rust_tpu_torch.tools.bench_encode_e2e [RUNS]

Port of the JAX package's ``tools/bench_encode_e2e.py``. One warm-up
``encode_many`` (every output must equal its corpus container, which the
native encoder wrote), then ``RUNS`` (default 5) timed runs with ``stats``.
The wall, each host stage and each CUDA-event device stage is the
second-smallest over the runs. Unlike the JAX tool, the device is timed
inside the real call (CUDA events), not modelled from in-jit repetition;
under ``LZT_ENC_CHUNKS`` the wall is the pipelined call's own, and
``pipeline_chunks`` is reported (the JAX tool modelled the overlap
instead).

With ``LZT_ENC_DEVFE=1``, as in the JAX tool, the device frontend
(``TorchEncoder("cuda", frontend="device")``) also encodes the batch: one
warm-up (every output equal to its corpus container) and 2 timed runs,
the smallest of each under ``device_frontend``: its wall and GB/s, the
host stages, the match stage's CUDA-event ms summed over the window sizes
(upload, kernel with compaction, download) and the bytes it brought back.
On the full serving batch that takes minutes (the host merge).
The last line is one JSON object.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..utils import corpus as CP
from .common import require_card, second_smallest, serving_pairs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    require_card("bench_encode_e2e")
    runs = int(argv[0]) if argv else 5
    pairs = [(r, c) for r, c in serving_pairs() if c != CP.EMPTY]
    out = measure(pairs, runs)
    if os.environ.get("LZT_ENC_DEVFE", "0") == "1":
        out["device_frontend"] = device_frontend(pairs)
    print(json.dumps(out))
    return 0


def measure(pairs, runs: int = 5, enc=None) -> dict:
    """``enc.encode_many`` (default ``TorchEncoder("cuda")``) on the raw
    inputs of ``pairs``: one warm-up whose every output must equal its
    container (else ``RuntimeError``), then ``runs`` timed runs; the wall,
    each host stage and each CUDA-event device stage the second-smallest
    over the runs. Prints two summary lines; returns the tool's JSON
    object."""
    from .. import TorchEncoder
    raws = [r for r, _ in pairs]
    total = sum(map(len, raws))
    enc = TorchEncoder("cuda") if enc is None else enc
    outs = enc.encode_many(raws)
    bad = sum(o != c for o, (_, c) in zip(outs, pairs))
    if bad:
        raise RuntimeError(f"{bad} outputs differ from the native encoder's")
    walls, stats = [], []
    for _ in range(runs):
        st: dict = {}
        t = time.perf_counter()
        enc.encode_many(raws, st)
        walls.append(time.perf_counter() - t)
        stats.append(st)
    wall = second_smallest(walls)
    host = {k: second_smallest([s[k] for s in stats]) * 1e3
            for k in ("small", "frontend", "emit_prep", "emit_dispatch",
                      "emit_kernels", "pack") if k in stats[0]}
    dev = {k: second_smallest([s["detail_device"][k] for s in stats])
           for k in stats[0].get("detail_device", {})}
    out = {"metric": "full_encode_GBps", "value": total / wall / 1e9,
           "raw_bytes": total, "n_sources": len(raws), "runs": runs,
           "wall_ms": wall * 1e3, "stages_ms": host,
           "detail_device_ms": dev,
           "upload_bytes": stats[0]["upload_bytes"],
           "download_bytes": stats[0]["download_bytes"],
           "pipeline_chunks": stats[0]["pipeline_chunks"],
           "byte_identical": True}
    print(f"{len(raws)} sources, {total} raw bytes: encode_many "
          f"{wall * 1e3:.3f} ms = {total / wall / 1e9:.4f} GB/s "
          f"(2nd-smallest of {runs}); every output equals the native "
          f"encoder's", flush=True)
    print("stages ms " + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + "; device events ms " + ", ".join(f"{k} {v:.3f}"
                                               for k, v in dev.items()),
          flush=True)
    return out


def device_frontend(pairs, runs: int = 2) -> dict:
    """The device frontend on the same raw inputs: the smallest of ``runs``
    timed calls for the wall and each stage."""
    from .. import TorchEncoder
    raws = [r for r, _ in pairs]
    total = sum(map(len, raws))
    enc = TorchEncoder("cuda", frontend="device")
    bad = sum(o != c for o, (_, c) in zip(enc.encode_many(raws), pairs))
    if bad:
        raise RuntimeError(f"device frontend: {bad} outputs differ from the "
                           f"native encoder's")
    walls, stats = [], []
    for _ in range(runs):
        st: dict = {}
        t = time.perf_counter()
        enc.encode_many(raws, st)
        walls.append(time.perf_counter() - t)
        stats.append(st)
    wall = min(walls)
    match = {k: min([sum(d[k] for d in s["detail_match"]) for s in stats])
             for k in ("upload_ms", "kernel_ms", "download_ms")}
    res = {"full_encode_GBps": total / wall / 1e9, "wall_ms": wall * 1e3,
           "stages_ms": {k: min([s[k] for s in stats]) * 1e3 for k in (
               "small", "win_prep", "matchfind", "arbitrate", "merge",
               "select", "emit_prep", "emit_dispatch", "emit_kernels",
               "pack")},
           "match_events_ms": match,
           "match_download_bytes": sum(
               d["download_bytes"] for d in stats[0]["detail_match"]),
           "windows": sum(d["windows"] for d in stats[0]["detail_match"])}
    print(f"device frontend: encode_many {wall * 1e3:.3f} ms = "
          f"{total / wall / 1e9:.4f} GB/s (smallest of {runs}); match stage "
          f"events ms {match}", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main())
