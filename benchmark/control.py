"""The control and the planted faults: runs whose answers must come out
not correct.

    python3 benchmark/control.py --workload snappy.decode --seeds 11 12 13 \
        [--mode control] [--seconds 3]

Each seed is one run of the cell through the harness, with the program's
call replaced under the window (``--mode``):

- ``control``: the plain reference in the program's place with one
  guarantee of the configuration broken. Decode: the raw bytes the
  reference decodes to, each output with one byte (at a seeded place)
  altered. Encode: the reference's RAW containers of the raw inputs,
  lossless but not the reference encoder's bytes.
- ``unchanged``: a step that returns its state unchanged (decode: the
  input containers; encode: the raw inputs).
- ``half``: half of the batch left out (the outputs of the first half
  only).
- ``altered``: the program's answer with one byte of one output (drawn
  from the seed) altered where it is produced.

A cell on one card has no exchange between chips to leave out. Prints
each run's checks and exits 0 only when every run came out not correct.
The benchmark's own runs never run this. The tests run it on the CPU with
``host_engine``, the program's native codec on the host in place of the
card's engines.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("control", "unchanged", "half", "altered")


def _flip(b: bytes, rng) -> bytes:
    """``b`` with one byte, at a place drawn by ``rng``, altered."""
    if not b:
        return b"\x00"
    i = int(rng.integers(len(b)))
    return b[:i] + bytes([b[i] ^ 0x5A]) + b[i + 1:]


def wrap_with(mode: str, seed: int):
    """A ``harness.run_cell`` wrapper that breaks the op's calls by
    ``mode``."""
    from benchmark.corpus import seed_key
    from benchmark.reference import constants as C
    from benchmark.reference import frontend as SF
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    rng = np.random.default_rng([seed_key(seed), 31])

    def wrap(op):
        call = op.call
        decode = type(op).__name__ == "DecodeOp"
        if mode == "control":
            eos = C.MAGIC_EOS.to_bytes(4, "little")
            fixed = ([_flip(r, rng) for r in op.raws] if decode else
                     [SF.encode_raw(r) + eos for r in op.raws])
            op.call = lambda engine, stats: list(fixed)
        elif mode == "unchanged":
            op.call = lambda engine, stats: list(
                op.batch if decode else op.raws)
        elif mode == "half":
            op.call = lambda engine, stats: call(engine, stats)[
                :len(op.raws) // 2]
        else:
            k = int(rng.integers(len(op.raws)))

            def altered(engine, stats):
                outs = list(call(engine, stats))
                outs[k] = _flip(outs[k], np.random.default_rng(k))
                return outs
            op.call = altered
        return op
    return wrap


def host_engine(op):
    """The op's calls on the host with the program's native codec (one
    container or source at a time), for runs without a card."""
    from lzfse_rust_tpu_torch.runtime.build import native_runtime
    nat = native_runtime()
    decode = type(op).__name__ == "DecodeOp"
    op.engine = lambda device: None
    op.call = lambda engine, stats: [
        (nat.decode_bytes if decode else nat.encode_bytes)(x)
        for x in op.batch]
    return op


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=MODES, default="control")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ok = True
    for seed in args.seeds:
        res, lines = harness.run_cell(args.workload, seed, args.seconds,
                                      False, "cuda", time.perf_counter(),
                                      wrap=wrap_with(args.mode, seed))
        checks = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "checks": checks}), flush=True)
        ok &= not res["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
