"""Per-primitive microbenchmark on the card: ns per op of the primitives the
TPU decode kernels were built from.

    python3 -m lzfse_rust_tpu_torch.tools.microbench_vpu

Port of the JAX package's ``tools/microbench_vpu.py``: the same rows in
the same order. A ``chain`` row is a ``probe_chain`` kernel (32 dependent
ops per step: latency); a ``tput`` row a ``probe_tput`` kernel (8
independent ops per step, summed: issue rate). On the card a 128-lane row
is one warp, 4 lanes per thread: a roll is ``__shfl_sync`` plus a register
rotate, a gather one shared-memory load. Inputs are the TPU tool's ranges
from a seed. Per op: (t(n) - t(n/8)) / (7n/8 * ops per step), CUDA events
around launches.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_probes as P
from .common import per_step_ms, require_card


class Row(NamedTuple):
    name: str
    kind: str     # "chain" (probe_chain) or "tput" (probe_tput)
    body: str
    n_steps: int


ROWS = (
    Row("add (chain)", "chain", "add", 200_000),
    Row("gather128 (chain)", "chain", "gather128", 50_000),
    Row("roll (chain)", "chain", "roll", 100_000),
    Row("select (chain)", "chain", "select", 100_000),
    Row("gather128 (indep)", "chain", "gather128_indep", 50_000),
    Row("shift pair", "chain", "shift_pair", 100_000),
    Row("gather idx<16 (indep)", "chain", "gather16", 50_000),
    Row("xor only", "chain", "xor", 200_000),
    Row("gather x8 indep (tput)", "tput", "gather_x8", 30_000),
    Row("roll x8 indep (tput)", "tput", "roll_x8", 30_000),
    Row("prefix 2-chained-roll", "chain", "prefix_chain", 50_000),
    Row("prefix 3-indep-roll", "chain", "prefix_tree", 50_000),
    Row("sim lit step (g,3r,g)", "chain", "lit_step", 30_000),
)


def inputs(seed: int = 0):
    """(tab (8, 1024), x (8, 128)) on the card, in the TPU tool's range
    [0, 128)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 128, shape).astype(
        np.int32)).cuda() for shape in ((8, 1024), (8, 128)))


def kernel_of(row: Row):
    return P.probe_chain if row.kind == "chain" else P.probe_tput


def measure(row: Row, seed: int = 0) -> dict:
    """One row on the card: ns per op."""
    tab, x = inputs(seed)
    fn = kernel_of(row)
    ms = per_step_ms(lambda n: fn(row.body, tab, x, n), row.n_steps)
    ops = P.N_OPS if row.kind == "chain" else P.TPUT_WIDTH
    return {"name": row.name, "kind": row.kind, "body": row.body,
            "ns_per_op": ms * 1e6 / ops}


def report(r: dict) -> str:
    return f"{r['name']:28s} {r['ns_per_op']:7.3f} ns/op"


def main(argv=None) -> int:
    require_card("microbench_vpu")
    for row in ROWS:
        print(report(measure(row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
