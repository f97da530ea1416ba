"""The port's benchmark: full container decode of the serving batch on the
card, in GB/s, with the full encode beside it.

    python3 -m lzfse_rust_tpu_torch.tools.bench [--min-mib N]

Counterpart of the root ``bench.py``. It prints the card line (the
``nvidia-smi`` name and power limit), then one JSON line shaped like
``bench.py``'s: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``extra``. Progress goes to standard error. Without CUDA it raises
``NoCardError``; nothing falls back to the host.

- Batch: ``utils/corpus.serving_batch(seed=0, min_bytes=N MiB)`` (default
  128 MiB), the in-repo seeded corpus in the Snappy files' kind shares; it
  reads no file outside the repository.
- Gates, before any timing: one ``TorchDecoder("cuda").decode_many`` and
  one ``api.decode_many`` (the API's card route, the same engine); every
  output's SHA-256 must equal its raw input's and ``stats["fallbacks"]``
  must be 0, else ``GateError``. Every timed run's outputs must then equal
  the raw inputs too.
- Metric ``full_decode_GBps_card``: raw bytes out over the wall seconds of
  one warm ``TorchDecoder.decode_many``, host stages included; ``value``
  is the median of ``RUNS`` runs, taken in turns with the API's card route
  (the two swap order between runs, so only runs taken in turns compare).
  ``extra`` has every run, the minimum and maximum, the median stage split
  (``parse``, ``prep``, ``device``, ``flatten``, ``rebuild``) and the
  median CUDA-event ``detail_device`` (upload, kernels, download ms);
  ``entropy_GBps`` is the raw bytes over ``kernels_ms`` alone.
- ``vs_baseline``: the value over the rate of the port's
  ``runtime.native.decode_bytes(s, parallel=False)`` over the same batch on
  one host thread, timed in this run (``extra.baseline``). The root
  bench's per-file reference rates price the Snappy files, not this batch.
  ``extra.host_threads`` gives the host thread pool's rate
  (``native.decode_into`` on ``min(cpu_count, 8)`` threads).
- ``extra.encode``: ``tools/bench_encode_e2e.measure`` on the batch's raw
  inputs through ``TorchEncoder("cuda").encode_many`` (every container
  equal to the corpus's, else the tool fails).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

from .. import api
from ..runtime.build import native_runtime
from ..utils import corpus as CP
from . import bench_encode_e2e
from .common import card_line, require_card

METRIC = "full_decode_GBps_card"
RUNS = 7            # timed decode runs of each route
BASELINE_RUNS = 3   # timed passes of each host decode
ENCODE_RUNS = 5
STAGES = ("parse", "prep", "device", "flatten", "rebuild")


class GateError(RuntimeError):
    """An output of the benchmark's run is wrong: no number is reported."""


def engines():
    """The batch decoder and encoder this tool measures."""
    from .. import TorchDecoder, TorchEncoder
    return TorchDecoder("cuda"), TorchEncoder("cuda")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sha_gate(what: str, outs, digests, stats: dict) -> None:
    """Every output's SHA-256 equals its raw input's; no fallback."""
    bad = [i for i, (o, d) in enumerate(zip(outs, digests))
           if hashlib.sha256(o).digest() != d]
    if len(outs) != len(digests) or bad:
        raise GateError(f"{what}: {len(bad)} outputs fail the SHA-256 gate "
                        f"(first {bad[:8]}), {len(outs)} outputs for "
                        f"{len(digests)} inputs")
    if stats.get("fallbacks", 0):
        raise GateError(f"{what}: {stats['fallbacks']} spec-layer fallbacks")


def _spread(walls: list, n_bytes: int) -> dict:
    """Every run's ms, the median, minimum and maximum, and the median's
    GB/s."""
    med = statistics.median(walls)
    return {"runs_ms": [w * 1e3 for w in walls], "median_ms": med * 1e3,
            "min_ms": min(walls) * 1e3, "max_ms": max(walls) * 1e3,
            "GBps": n_bytes / med / 1e9}


def decode_runs(dec, sources, raws, runs: int = RUNS) -> tuple[dict, list]:
    """``runs`` timed runs of ``dec.decode_many`` and of the API's card
    route, in turns. Returns each route's walls (seconds) and the
    decoder's stats per run."""
    walls: dict = {"decoder": [], "api": []}
    stats: list = []
    for _ in range(runs):
        st: dict = {}
        t = time.perf_counter()
        outs = dec.decode_many(sources, st)
        walls["decoder"].append(time.perf_counter() - t)
        if outs != raws or st.get("fallbacks", 0):
            raise GateError("TorchDecoder: a timed run's outputs differ from "
                            "the raw inputs")
        stats.append(st)
        t = time.perf_counter()
        outs = api.decode_many(sources)
        walls["api"].append(time.perf_counter() - t)
        if outs != raws:
            raise GateError("api.decode_many: a timed run's outputs differ "
                            "from the raw inputs")
        del outs
    return walls, stats


def host_decode(sources, raws, runs: int = BASELINE_RUNS) -> tuple[dict,
                                                                   dict]:
    """The one-thread native decode of the batch (the baseline), then the
    host thread pool's (``decode_into`` into preallocated buffers on
    ``min(cpu_count, 8)`` threads), each timed ``runs`` times."""
    native = native_runtime()
    n_bytes = sum(map(len, raws))
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        outs = [native.decode_bytes(s, parallel=False) for s in sources]
        walls.append(time.perf_counter() - t)
        if outs != raws:
            raise GateError("native.decode_bytes: outputs differ from the "
                            "raw inputs")
        del outs
    one = {"what": "runtime.native.decode_bytes(s, parallel=False) over the "
                   "same batch, one host thread, timed in this run",
           **_spread(walls, n_bytes)}
    threads = min(os.cpu_count() or 1, 8)
    bufs = [np.empty(native.decode_bound(s), np.uint8) for s in sources]

    def one_into(k: int) -> int:
        return native.decode_into(sources[k], bufs[k], parallel=False)

    walls = []
    with cf.ThreadPoolExecutor(threads) as ex:
        for _ in range(runs):
            t = time.perf_counter()
            ns = list(ex.map(one_into, range(len(sources))))
            walls.append(time.perf_counter() - t)
            if any(b[:n].tobytes() != r for b, n, r in zip(bufs, ns, raws)):
                raise GateError("native.decode_into: outputs differ from "
                                "the raw inputs")
    pool = {"what": f"runtime.native.decode_into(s, buf, parallel=False) on "
                    f"{threads} host threads, preallocated buffers",
            "threads": threads, **_spread(walls, n_bytes)}
    return one, pool


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m lzfse_rust_tpu_torch."
                                "tools.bench", description=__doc__.split(
                                    "\n\n")[0])
    p.add_argument("--min-mib", type=int, default=CP.SERVING_BYTES >> 20,
                   help="raw MiB of the serving batch at least (default "
                        "%(default)s)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    kind = require_card("bench")

    t = time.perf_counter()
    pairs = CP.serving_batch(seed=0, min_bytes=args.min_mib << 20)
    sources = [c for _, c in pairs]
    raws = [r for r, _ in pairs]
    raw_bytes = sum(map(len, raws))
    n_fse = len(native_runtime().walk_batch(sources)[0])
    batch = {"source": f"utils/corpus.serving_batch(seed=0, "
                       f"min_bytes={args.min_mib} MiB): the in-repo seeded "
                       f"corpus in the Snappy files' kind shares, not the "
                       f"Snappy files",
             "containers": len(sources), "raw_bytes": raw_bytes,
             "compressed_bytes": sum(map(len, sources)),
             "fse_blocks": n_fse}
    _log(f"batch: {batch}, made in {time.perf_counter() - t:.1f} s")

    dec, enc = engines()
    digests = [hashlib.sha256(r).digest() for r in raws]
    st: dict = {}
    sha_gate("TorchDecoder.decode_many", dec.decode_many(sources, st),
             digests, st)
    sha_gate("api.decode_many", api.decode_many(sources), digests, {})
    _log("gates passed: SHA-256 of every output, no fallback")

    walls, stats = decode_runs(dec, sources, raws)
    decoder = _spread(walls["decoder"], raw_bytes)
    stages = {k: statistics.median(s[k] for s in stats) * 1e3
              for k in STAGES if k in stats[0]}
    detail = {k: statistics.median(s["detail_device"][k] for s in stats)
              for k in stats[0].get("detail_device", {})}
    one, pool = host_decode(sources, raws)
    _log(f"decode: TorchDecoder median {decoder['median_ms']:.3f} ms, host "
         f"one thread {one['median_ms']:.3f} ms")

    with contextlib.redirect_stdout(sys.stderr):
        e2e = bench_encode_e2e.measure(
            [(r, c) for r, c in pairs if c != CP.EMPTY], ENCODE_RUNS, enc)
    encode = {"full_encode_GBps_card": e2e["value"],
              "what": "TorchEncoder('cuda').encode_many on the batch's raw "
                      "inputs, every container equal to the corpus's; "
                      "second-smallest of the timed runs",
              **{k: e2e[k] for k in ("wall_ms", "runs", "n_sources",
                                     "raw_bytes", "stages_ms",
                                     "detail_device_ms", "byte_identical")}}

    value = decoder["GBps"]
    extra = {"device": kind, "card": card_line(), "batch": batch,
             "runs_ms": decoder["runs_ms"],
             "median_ms": decoder["median_ms"],
             "min_ms": decoder["min_ms"], "max_ms": decoder["max_ms"],
             "api_card_route": _spread(walls["api"], raw_bytes),
             "stages_ms": stages, "detail_device_ms": detail,
             "entropy_GBps": (raw_bytes / detail["kernels_ms"] / 1e6
                              if detail.get("kernels_ms") else None),
             "baseline": one, "host_threads": pool, "encode": encode,
             "gates": "SHA-256 of every output, fallbacks == 0, timed "
                      "outputs equal the raw inputs"}
    print(json.dumps({"metric": METRIC, "value": round(value, 4),
                      "unit": "GB/s",
                      "vs_baseline": round(value / one["GBps"], 3),
                      "extra": extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
