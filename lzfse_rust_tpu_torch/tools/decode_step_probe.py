"""Where the decode kernels' time goes: one stream's step, and what parts
of the step cost.

    python3 -m lzfse_rust_tpu_torch.tools.decode_step_probe

Needs an NVIDIA GPU. On the kernel arguments of the seeded serving batch it
times both decode kernels with CUDA events, first on every stream, then on
the longest stream alone (every other stream gets 0 steps). The second time
over that stream's step count is the latency of one step of the chain: no
batch can finish faster than its longest stream takes at that rate. Then
it builds variants of ``csrc/fse_decode.cu`` with one part taken out, and
times each on the longest stream alone:

* ``no_stores``: outputs not written (the work that only feeds them goes
  too);
* ``no_refills``: the ring is filled once and never refilled (the outputs
  are then wrong; only the time counts).

The last line is one JSON object.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import cuda_decode as K
from ..runtime import cuda_lib
from ..utils.timing import cuda_ms
from .block_size_probe import library
from .common import decode_inputs, require_card

# variant -> (source text, replacement) pairs; each must match exactly once
# or more (a changed kernel makes the probe raise, not measure the wrong
# thing)
VARIANTS = {
    "no_stores": (
        ("    store_round(dst + step, packed, step + kRound <= o_lim, "
         "o_lim - step);\n", ""),
        ("    if (step < o_lim) dst[step] = (int32_t)packed;\n",
         "    (void)packed;\n"),
        ("    store_round(dlm + step, lm, whole, o_lim - step);\n"
         "    store_round(dd + step, d, whole, o_lim - step);\n", ""),
        ("    if (step < o_lim) {\n      dlm[step] = (int32_t)lm;\n"
         "      dd[step] = (int32_t)d;\n    }\n", ""),
    ),
    "no_refills": (("    st.ring.round(st.top - 3);\n", ""),),
}


def variant_source(src: str, name: str) -> str:
    """``fse_decode.cu`` with the parts of variant ``name`` taken out."""
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: {old.strip()!r} not in "
                               f"{K.SOURCE.name}")
        src = src.replace(old, new)
    return src


def longest_only(args: dict) -> dict:
    """The arguments with every stream but the first (the longest: the
    host orders them longest first) given 0 steps."""
    num = args["num"].clone()
    num[1:] = 0
    return {**args, "num": num}


def steps_of(name: str, args: dict) -> int:
    n = int(args["num"][0])
    return (n + 3) // 4 if name == "literal" else n


def main(argv=None) -> int:
    require_card("decode_step_probe")
    _, _, lit, lmd, _ = decode_inputs()
    kernels = {"literal": (K.decode_literals, lit), "lmd": (K.decode_lmds, lmd)}
    out = {"streams_per_block": K.streams_per_block(),
           "streams": lit["tables"].shape[0], "all_ms": {}, "longest": {},
           "variants_longest_ms": {}}
    for name, (fn, args) in kernels.items():
        out["all_ms"][name] = cuda_ms(lambda: fn(**args), reps=10, warmup=2)
        one = longest_only(args)
        ms = cuda_ms(lambda: fn(**one), reps=10, warmup=2)
        steps = steps_of(name, one)
        out["longest"][name] = {"steps": steps, "ms": ms,
                                "ns_per_step": ms * 1e6 / max(steps, 1)}
        print(f"{name}: all streams {out['all_ms'][name]:.4f} ms; longest "
              f"stream alone {steps} steps in {ms:.4f} ms = "
              f"{ms * 1e6 / max(steps, 1):.1f} ns/step", flush=True)
    libs = {v: library(f"step_{v}", {K.SOURCE.name: variant_source(
        K.SOURCE.read_text(), v)}) for v in VARIANTS}
    shipped = cuda_lib.lib()
    try:
        for v, lib in libs.items():
            cuda_lib._LIB = lib
            row = {}
            for name, (fn, args) in kernels.items():
                one = longest_only(args)
                row[name] = cuda_ms(lambda: fn(**one), reps=10, warmup=2)
            out["variants_longest_ms"][v] = row
            print(f"{v}: longest stream alone, literal {row['literal']:.4f} "
                  f"ms, lmd {row['lmd']:.4f} ms", flush=True)
    finally:
        cuda_lib._LIB = shipped
    torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
