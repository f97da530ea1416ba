"""Shape model of the card's four codec kernels: how much of the issued
work is wasted on threads that finished early, against the batch size.

    python3 -m lzfse_rust_tpu_torch.tools.predict_utilization

Port of the JAX package's ``tools/predict_utilization.py``, for this
card's kernels. Each kernel runs one thread per stream (FSE block or
staged slot); the streams are taken longest first (``cuda_decode`` and
``cuda_encode`` slot order), so each warp holds up to 32 streams of
similar length, and a warp costs its longest stream's step count. A
decode warp holds the streams of one CUDA block (``kStreams``); an encode
CUDA block's ``kSlots`` slots run their chains side by side, so it costs
its longest slot. The wasted share is 1 - (steps of all streams) /
(streams per group x sum over groups of the longest step count). Step
counts are the serving batch's, from the kernels' arguments as
``TorchDecoder`` and ``TorchEncoder`` build them. The batch is
scaled from 1/8 to 4 times the serving batch (the first blocks of the
batch, or replicas); the JAX tool's scale was the corpus replica count,
and the serving batch stands for 48 replicas. Also printed: CUDA blocks
per kernel (decode: ``kStreams`` streams per block, read from
``csrc/fse_decode.cu``; encode: ``kSlots`` slots per block, read from
``csrc/fse_encode.cu``) against the card's 132 SMs. Pure shape math; it
runs on the host.
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops import cuda_decode as KD
from ..ops import cuda_encode as KE
from .common import require_card, serving_pairs

WARP = 32
SMS = 132
SCALES = (0.125, 0.25, 0.5, 1, 2, 4)


def warp_waste(steps, warp: int = WARP) -> dict:
    """Useful and issued thread-steps when ``steps`` streams run one per
    thread, longest first, a warp costing its longest stream."""
    s = np.sort(np.asarray(steps, np.int64))[::-1]
    n = len(s)
    pad = np.zeros(-(-n // warp) * warp, np.int64)
    pad[:n] = s
    issued = int(pad.reshape(-1, warp).max(axis=1).sum()) * warp
    useful = int(s.sum())
    return {"streams": n, "warps": len(pad) // warp, "useful": useful,
            "issued": issued,
            "wasted_share": 1 - useful / issued if issued else 0.0}


def streams_per_block() -> dict:
    """Streams (decode) or slots (encode) per CUDA block of each kernel,
    read from the sources."""
    dec = KD.streams_per_block()
    enc = KE.slots_per_block()
    return {"decode literals": dec, "decode lmds": dec,
            "encode literals": enc, "encode lmds": enc}


def step_counts(pairs) -> dict:
    """Per-stream step counts of each kernel for a batch of ``(raw,
    container)`` pairs, from the kernels' own arguments as the decoder and
    the encoder build them on the host (period-split alternatives
    included)."""
    from .. import TorchDecoder, TorchEncoder
    lit, lmd = TorchDecoder("cpu").kernel_args([c for _, c in pairs])
    e_lit, e_lmd = TorchEncoder("cpu").kernel_args([r for r, _ in pairs])
    return {"decode literals": KD.literal_counts(lit["num"].numpy()),
            "decode lmds": lmd["num"].numpy().astype(np.int64),
            "encode literals": KE.steps_of("literals", e_lit["num"].numpy(),
                                           e_lit["words"].shape[1]),
            "encode lmds": KE.steps_of("lmds", e_lmd["num"].numpy(),
                                       e_lmd["lm"].shape[1])}


def scaled(steps, scale: float):
    """The first ``scale`` share of the streams, or ``scale`` replicas."""
    steps = np.asarray(steps)
    if scale >= 1:
        return np.tile(steps, int(scale))
    return steps[:max(1, int(len(steps) * scale))]


def main(argv=None) -> int:
    require_card("predict_utilization")
    counts = step_counts(serving_pairs())
    per_block = streams_per_block()
    print(f"{'scale':>6} {'kernel':>16} {'streams':>8} {'CUDA blocks':>11} "
          f"{'SM share':>8} {'wasted share':>12}")
    for scale in SCALES:
        for name, steps in counts.items():
            w = warp_waste(scaled(steps, scale),
                           min(WARP, per_block[name]))
            blocks = -(-w["streams"] // per_block[name])
            print(f"{scale:>6} {name:>16} {w['streams']:>8} {blocks:>11} "
                  f"{min(1.0, blocks / SMS):>8.3f} "
                  f"{w['wasted_share']:>12.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
