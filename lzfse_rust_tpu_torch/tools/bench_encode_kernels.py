"""The E-table build and both encode kernels on the serving batch's staged
blocks, timed on the card.

    python3 -m lzfse_rust_tpu_torch.tools.bench_encode_kernels

Port of the JAX package's ``tools/bench_encode_kernels.py``. The serving
batch's raw inputs go through ``TorchEncoder``'s own staging (the native
frontend into the pinned pool, the live rows up to the card, slots
ordered longest first), so the kernels see exactly what ``encode_many``
gives them, period-split alternatives included. Then, each the mean of 10
runs after 2 warm-ups in CUDA events: ``build_encode_tables`` (torch ops),
the literal kernel and the L/M/D kernel (``csrc/fse_encode.cu``). Then
each kernel on the longest slot alone (every other slot gets 0 steps): its
time over that slot's step count is the latency of one step of the state
chain, which no batch can beat. The last line is one JSON object.
"""

from __future__ import annotations

import json
import sys

import torch

from ..base import constants as C
from ..ops import cuda_encode as KE
from ..ops.fse_encode import build_encode_tables
from ..utils import corpus as CP
from ..utils.timing import cuda_ms
from .common import require_card, serving_pairs


def longest_only(args: dict) -> dict:
    """The arguments with every slot but the longest (the first of
    ``order``) given 0 steps."""
    num = torch.zeros_like(args["num"])
    first = args["order"][0].long()
    num[first] = args["num"][first]
    return {**args, "num": num}


def main(argv=None) -> int:
    from .. import TorchEncoder
    require_card("bench_encode_kernels")
    raws = [r for r, c in serving_pairs() if c != CP.EMPTY]
    big = [i for i, s in enumerate(raws) if len(s) > C.VN_CUTOFF]
    enc = TorchEncoder("cuda")
    pool, nb, _, _, _ = enc._frontends(raws, big)
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
    longest = {}
    for kind, fn, args in (("literals", KE.encode_literals, lit),
                           ("lmds", KE.encode_lmds, lmd)):
        one = longest_only(args)
        steps = int(KE.steps_of(kind, one["num"], n_cols).max())
        t = cuda_ms(lambda: fn(**one), reps=10, warmup=2)
        longest[kind] = {"steps": steps, "ms": t,
                         "ns_per_step": t * 1e6 / max(steps, 1)}
    raw = sum(len(raws[i]) for i in big)
    total = sum(ms.values())
    print(f"{nb} staged slots from {len(big)} sources ({raw} raw bytes); "
          f"push groups: literal {groups['literals']}, L/M/D "
          f"{groups['lmds']}", flush=True)
    for name, t in ms.items():
        print(f"{name:10s} {t:9.4f} ms", flush=True)
    print(f"E tables + encode kernels {total:.4f} ms per pass -> "
          f"{raw / total / 1e6:.4f} GB/s of raw bytes", flush=True)
    for kind, row in longest.items():
        print(f"{kind}: longest slot alone {row['steps']} steps in "
              f"{row['ms']:.4f} ms = {row['ns_per_step']:.1f} ns/step",
              flush=True)
    print(json.dumps({"slots": nb, "slots_per_block": KE.slots_per_block(),
                      "raw_bytes": raw, "groups": groups, "ms": ms,
                      "longest": longest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
