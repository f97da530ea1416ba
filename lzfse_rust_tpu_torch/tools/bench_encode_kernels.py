"""The E-table build and both encode kernels on the serving batch's staged
blocks, timed on the card.

    python3 -m lzfse_rust_tpu_torch.tools.bench_encode_kernels

Port of the JAX package's ``tools/bench_encode_kernels.py``. The serving
batch's raw inputs go through ``TorchEncoder``'s own staging (the native
frontend into the pinned pool, the live rows up to the card, slots
ordered longest first), so the kernels see exactly what ``encode_many``
gives them, period-split alternatives included. Then, each the mean of 10
runs after 2 warm-ups in CUDA events: ``build_encode_tables`` (torch ops),
the literal kernel and the L/M/D kernel (``csrc/fse_encode.cu``). The last
line is one JSON object.
"""

from __future__ import annotations

import json
import sys

from ..base import constants as C
from ..ops import cuda_encode as KE
from ..ops.fse_encode import build_encode_tables
from ..utils import corpus as CP
from ..utils.timing import cuda_ms
from .common import require_card, serving_pairs


def main(argv=None) -> int:
    from .. import TorchEncoder
    require_card("bench_encode_kernels")
    raws = [r for r, c in serving_pairs() if c != CP.EMPTY]
    big = [i for i, s in enumerate(raws) if len(s) > C.VN_CUTOFF]
    enc = TorchEncoder("cuda")
    pool, nb, _, _ = enc._frontends(raws, big)
    dev = enc._upload(pool, nb)
    lit, lmd = enc._kwargs(dev)
    n_cols = lit["words"].shape[1]
    groups = {k: int(KE.steps_of(k, a["num"], n_cols).sum())
              for k, a in (("literals", lit), ("lmds", lmd))}
    ms = {
        "tables": cuda_ms(lambda: build_encode_tables(dev["weights"]),
                          reps=10, warmup=2),
        "literals": cuda_ms(lambda: KE.encode_literals(**lit), reps=10,
                            warmup=2),
        "lmds": cuda_ms(lambda: KE.encode_lmds(**lmd), reps=10, warmup=2),
    }
    raw = sum(len(raws[i]) for i in big)
    total = sum(ms.values())
    print(f"{nb} staged slots from {len(big)} sources ({raw} raw bytes); "
          f"push groups: literal {groups['literals']}, L/M/D "
          f"{groups['lmds']}", flush=True)
    for name, t in ms.items():
        print(f"{name:10s} {t:9.4f} ms", flush=True)
    print(f"E tables + encode kernels {total:.4f} ms per pass -> "
          f"{raw / total / 1e6:.4f} GB/s of raw bytes", flush=True)
    print(json.dumps({"slots": nb, "raw_bytes": raw, "groups": groups,
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
