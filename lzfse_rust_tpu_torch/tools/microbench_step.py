"""Step-exact microbenchmark of the literal-step op mix on the card.

    python3 -m lzfse_rust_tpu_torch.tools.microbench_step [--multisym]

Port of the JAX package's ``tools/microbench_step.py``: the same rows
(names, step counts, vregs, table widths), each a ``probe_step`` kernel
(``csrc/probes.cu``) that applies one literal-step body ``n_steps`` times
to an (8 * n_vregs, 128) int32 tile. Inputs are the TPU tool's ranges,
drawn from a seed. Per step: (t(n) - t(n/8)) / (7n/8) with CUDA events
around launches; GB/s-lit counts 256 literals per vreg-step, as the TPU
tool does. Each row says where its table lived (shared or global memory).
``--multisym`` runs the table-size rows of the multi-symbol study.
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
    body: str
    n_steps: int
    n_vregs: int


ROWS = (
    Row("current step (1 vreg)", "current", 20_000, 1),
    Row("indep-roll step (1 vreg)", "indep_roll", 20_000, 1),
    Row("current step (2 vregs)", "current", 20_000, 2),
    Row("indep-roll step (2 vregs)", "indep_roll", 20_000, 2),
    Row("96 gathers issue floor", "gathers_only", 20_000, 1),
    Row("lookup_sec only", "lookup_only", 20_000, 1),
    Row("fast step 64g (1 vreg)", "fast", 20_000, 1),
    Row("fast step 64g (2 vregs)", "fast", 20_000, 2),
    Row("fast nosplit 80g (1 vreg)", "fast_nosplit", 20_000, 1),
)
MULTISYM_ROWS = (
    Row("lookup 8ch (1024w, baseline)", "lookup_8ch", 20_000, 1),
    Row("lookup 16ch (2048w)", "lookup_16ch", 20_000, 1),
    Row("lookup 32ch (4096w)", "lookup_32ch", 10_000, 1),
    Row("pair step 64ch (8 lit/step)", "pair_64", 10_000, 1),
)


def inputs(body: str, n_vregs: int, seed: int = 0):
    """(tab, chunk, x) on the card, in the TPU tool's ranges, from ``seed``."""
    rng = np.random.default_rng(seed)
    tw = P.STEP_BODIES[body]
    arrs = (rng.integers(0, 1024, (8, P.G * tw)),
            rng.integers(0, 2**31 - 1, (8, P.G * 256)),
            rng.integers(0, 128, (8 * n_vregs, 128)))
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda() for a in arrs)


def measure(row: Row, seed: int = 0) -> dict:
    """One row on the card: ns per step, GB/s of literals, table memory."""
    tab, chunk, x = inputs(row.body, row.n_vregs, seed)
    ms = per_step_ms(lambda n: P.probe_step(row.body, tab, chunk, x, n),
                     row.n_steps)
    ns = ms * 1e6
    return {"name": row.name, "body": row.body, "n_vregs": row.n_vregs,
            "ns_per_step": ns, "gbps_lit": 256 * row.n_vregs / ns,
            "memory": P.step_memory(row.body)}


def report(r: dict) -> str:
    return (f"{r['name']:34s} {r['ns_per_step']:8.1f} ns/step  "
            f"{r['gbps_lit']:6.2f} GB/s-lit  ({r['memory']} memory)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    require_card("microbench_step")
    for row in MULTISYM_ROWS if "--multisym" in argv else ROWS:
        print(report(measure(row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
