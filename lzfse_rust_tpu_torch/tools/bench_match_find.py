"""The device match finder on the card, per window size: host grouping,
upload, kernel, download and arbitration.

    python3 -m lzfse_rust_tpu_torch.tools.bench_match_find [RUNS]

Port of the grouped half of the JAX package's ``tools/bench_match_find.py``
(its argsort half, ``find_matches_device``, has no port). Every window of
the serving batch's raw inputs (seed 0) goes through
``TorchEncoder("cuda", frontend="device")._windows_compact_grouped``, the
device frontend's match stage as ``encode_many`` runs it: one warm-up, then
``RUNS`` (default 3) timed runs. Per window size N it reports the windows,
slots, matched and saturated slots and their shares; the host grouping
(``win_prep``: the window bytes and ``native.match_group`` on a host
thread pool), the upload, the kernel with the read of its totals and the
download of the compacted rows (CUDA events), the rest of the match stage
on the host, and the arbitration, each the second-smallest over the runs;
and the rate of window bytes through the host grouping, the kernel and the
whole stage. Then, per window size, ``torch.profiler``'s split of one
``match_rows`` call on the card: the fused match-and-compaction kernel,
the zeroing of its scratch and offsets, and the read of the totals (the
compaction runs inside the kernel and has no time of its own). The last
line is one JSON object.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..utils import corpus as CP
from .common import require_card, second_smallest, serving_pairs

# per window size: (report key, detail_match key, scale to milliseconds)
FIELDS = (("group_ms", "win_prep_s", 1e3), ("upload_ms", "upload_ms", 1.0),
          ("kernel_ms", "kernel_ms", 1.0),
          ("download_ms", "download_ms", 1.0),
          ("matchfind_ms", "matchfind_s", 1e3),
          ("arbitrate_ms", "arbitrate_s", 1e3))


def summarize(runs: list[list[dict]]) -> list[dict]:
    """One row per window size from each run's ``detail_match``: counts
    from the first run, every time the second-smallest over the runs, and
    rates of window bytes (N per window) in MB/s."""
    rows = []
    for k, first in enumerate(runs[0]):
        dets = [run[k] for run in runs]
        row = {key: first[key] for key in ("N", "windows", "slots", "sat",
                                          "matched", "upload_bytes",
                                          "download_bytes")}
        for key, src, scale in FIELDS:
            row[key] = second_smallest([d[src] * scale for d in dets])
        total = second_smallest([(d["win_prep_s"] + d["matchfind_s"]
                                  + d["arbitrate_s"]) * 1e3 for d in dets])
        row["stage_ms"] = total
        row["matched_share"] = row["matched"] / row["slots"]
        row["sat_share"] = row["sat"] / row["slots"]
        for key, ms in (("group_MBps", row["group_ms"]),
                        ("kernel_MBps", row["kernel_ms"]),
                        ("stage_MBps", total)):
            row[key] = row["slots"] / ms / 1e3 if ms > 0 else None
        rows.append(row)
    return rows


def report(row: dict) -> str:
    return (f"N {row['N']}: {row['windows']} windows, {row['slots']} slots "
            f"({row['matched']} matched = {row['matched_share']:.4%}, "
            f"{row['sat']} saturated = {row['sat_share']:.4%}; down "
            f"{row['download_bytes']} bytes); group "
            f"{row['group_ms']:.3f} ms, up {row['upload_ms']:.3f}, kernel "
            f"{row['kernel_ms']:.3f}, down {row['download_ms']:.3f}, match "
            f"stage {row['matchfind_ms']:.3f} (transfers and kernel "
            f"included), arbitrate {row['arbitrate_ms']:.3f}; whole "
            f"{row['stage_ms']:.3f} ms = {row['stage_MBps']:.1f} MB/s of "
            f"windows (kernel alone {row['kernel_MBps']:.1f})")


def profile_rows(args: dict) -> dict:
    """Device microseconds of one ``match_rows`` call by kernel name, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import match_find as MF
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        MF.match_rows(**args, vn=False)
        torch.cuda.synchronize()
    per: dict = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            name = ("match_rows_kernel" if "match_rows_kernel" in ev.name
                    else ev.name[:60])
            per[name] = per.get(name, 0.0) + ev.time_range.elapsed_us()
    return {k: round(v, 1) for k, v in per.items()}


def main(argv=None) -> int:
    from .. import TorchEncoder
    argv = sys.argv[1:] if argv is None else argv
    require_card("bench_match_find")
    runs = int(argv[0]) if argv else 3
    raws = [r for r, c in serving_pairs() if c != CP.EMPTY]
    enc = TorchEncoder("cuda", frontend="device")
    wins = enc.windows(raws)
    fulls = {i: np.frombuffer(raws[i], np.uint8) for i in {w[0] for w in wins}}
    enc._windows_compact_grouped(fulls, wins, False)
    dets, walls = [], []
    for _ in range(runs):
        st: dict = {}
        t = time.perf_counter()
        enc._windows_compact_grouped(fulls, wins, False, st)
        walls.append(time.perf_counter() - t)
        dets.append(st["detail_match"])
    rows = summarize(dets)
    for row in rows:
        print(report(row), flush=True)
    for args in enc.match_args(raws, wins):
        print(f"N {args['pads'].shape[1]}: match_rows device us "
              f"{profile_rows(args)}", flush=True)
        del args
    wall = second_smallest(walls)
    slots = sum(r["slots"] for r in rows)
    print(f"{len(wins)} windows, {slots} slots of {sum(map(len, raws))} raw "
          f"bytes: match stage {wall * 1e3:.3f} ms (2nd-smallest of {runs}) "
          f"= {slots / wall / 1e6:.1f} MB/s of windows", flush=True)
    print(json.dumps({"metric": "match_stage_ms", "value": wall * 1e3,
                      "windows": len(wins), "slots": slots, "runs": runs,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
