"""Time the codec kernels at each size of their one tuning constant: both
decode kernels at 4, 8, 16 and 32 streams per CUDA block, both encode
kernels at 1, 2, 4 and 8 slots per CUDA block (16 would need more than a
block's 227 KB of shared memory).

    python3 -m lzfse_rust_tpu_torch.tools.block_size_probe [decode] [encode]

Needs an NVIDIA GPU. With no argument it sweeps both. It builds one
variant of ``csrc/fse_decode.cu`` per streams-per-block count
(``kStreams``; into ``build/probe<S>/``) and one of ``csrc/fse_encode.cu``
per slots-per-block count (``kSlots``; into ``build/slots<S>/``), runs each
on the kernel inputs of the seeded serving batch that ``chip_smoke.py``
uses, checks its outputs bit for bit against the shipped build (encode:
the defined columns and the final states), and prints CUDA-event times in
two rounds of opposite order: each kernel alone, and ``kernels_ms`` of a
whole ``decode_many`` (both decode kernels side by side on two CUDA
streams) or ``encode_many`` (the E tables and both encode kernels), the
median of three calls. Exits 1 if a variant disagrees.
"""

from __future__ import annotations

import sys

import torch

from ..ops import cuda_decode as K
from ..ops import cuda_encode as KE
from ..runtime import build as B, cuda_lib
from ..utils import corpus as CP
from ..utils.timing import cuda_ms
from .common import require_card

SIZES = (4, 8, 16, 32)           # kStreams of fse_decode.cu
SLOT_SIZES = (1, 2, 4, 8)        # kSlots of fse_encode.cu


def variant_source(src: str, streams: int) -> str:
    """``fse_decode.cu`` with ``streams`` streams per CUDA block."""
    K.streams_per_block(src)   # exactly one line to rewrite
    return K.STREAMS_LINE.sub(f"constexpr int kStreams = {streams};", src)


def slots_source(src: str, slots: int) -> str:
    """``fse_encode.cu`` with ``slots`` slots per CUDA block."""
    KE.slots_per_block(src)    # exactly one line to rewrite
    return KE.SLOTS_LINE.sub(f"constexpr int kSlots = {slots};", src)


def library(name: str, replaced: dict[str, str]):
    """The kernel library built with the sources named in ``replaced``
    (file name -> text) in place of the shipped ones (into
    ``build/<name>/``), loaded."""
    d = B.BUILD_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    sources = []
    # every source, replaced or as shipped: the library must hold every
    # entry point
    for s in sorted(B.CSRC.glob("*.cu")):
        if s.name in replaced:
            s = d / s.name
            s.write_text(replaced[s.name])
        sources.append(s)
    return cuda_lib.load(B.kernel_library(d / "lib.so", sources))


def variant(streams: int):
    """The kernel library built with ``streams`` streams per CUDA block."""
    return library(f"probe{streams}", {K.SOURCE.name: variant_source(
        K.SOURCE.read_text(), streams)})


def slots_variant(slots: int):
    """The kernel library built with ``slots`` encode slots per CUDA
    block."""
    return library(f"slots{slots}", {KE.SOURCE.name: slots_source(
        KE.SOURCE.read_text(), slots)})


def sweep_decode() -> bool:
    from .. import TorchDecoder
    libs = {s: variant(s) for s in SIZES}
    pairs = CP.serving_batch(seed=0)
    sources = [c for _, c in pairs]
    dec = TorchDecoder("cuda")
    lit, lmd = dec.kernel_args(sources)
    print(f"{lit['tables'].shape[0]} streams, shipped "
          f"{K.streams_per_block()} per CUDA block", flush=True)
    want = (K.decode_literals(**lit), K.decode_lmds(**lmd))   # shipped build
    torch.cuda.synchronize()
    ok = True
    for rnd, order in enumerate((SIZES, SIZES[::-1])):
        for s in order:
            cuda_lib._LIB = libs[s]
            got = (K.decode_literals(**lit), K.decode_lmds(**lmd))
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for gs, ws in zip(got, want)
                       for g, w in zip(gs, ws))
            ok &= same
            lit_ms = cuda_ms(lambda: K.decode_literals(**lit), reps=10,
                             warmup=2)
            lmd_ms = cuda_ms(lambda: K.decode_lmds(**lmd), reps=10, warmup=2)
            both = []
            for _ in range(4):   # the first call warms up
                stats: dict = {}
                dec.decode_many(sources, stats)
                both.append(stats["detail_device"]["kernels_ms"])
            print(f"round {rnd} streams/block {s}: literal {lit_ms:.4f} ms, "
                  f"lmd {lmd_ms:.4f} ms, decode_many kernels_ms "
                  f"{sorted(both[1:])[1]:.4f}, same={same}", flush=True)
    return ok


def sweep_encode() -> bool:
    from .. import TorchEncoder
    libs = {s: slots_variant(s) for s in SLOT_SIZES}
    raws = [r for r, c in CP.serving_batch(seed=0) if c != CP.EMPTY]
    enc = TorchEncoder("cuda")
    lit, lmd = enc.kernel_args(raws)
    runs = (("literals", KE.encode_literals, lit),
            ("lmds", KE.encode_lmds, lmd))

    def outputs():
        return [KE.defined_columns(kind, fn(**args), args["num"])
                for kind, fn, args in runs]

    print(f"{lit['num'].numel()} staged slots, shipped "
          f"{KE.slots_per_block()} per CUDA block", flush=True)
    want = outputs()   # shipped build
    torch.cuda.synchronize()
    ok = True
    for rnd, order in enumerate((SLOT_SIZES, SLOT_SIZES[::-1])):
        for s in order:
            cuda_lib._LIB = libs[s]
            got = outputs()
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for gs, ws in zip(got, want)
                       for g, w in zip(gs, ws))
            ok &= same
            ms = [cuda_ms(lambda: fn(**args), reps=10, warmup=2)
                  for _, fn, args in runs]
            both = []
            for _ in range(4):   # the first call warms up
                stats: dict = {}
                enc.encode_many(raws, stats)
                both.append(stats["detail_device"]["kernels_ms"])
            print(f"round {rnd} slots/block {s}: literal {ms[0]:.4f} ms, "
                  f"lmd {ms[1]:.4f} ms, encode_many kernels_ms "
                  f"{sorted(both[1:])[1]:.4f}, same={same}", flush=True)
    return ok


def main(argv=None) -> int:
    require_card("block_size_probe")
    which = list(sys.argv[1:] if argv is None else argv) or ["decode",
                                                             "encode"]
    bad = sorted(set(which) - {"decode", "encode"})
    if bad:
        raise SystemExit(f"block_size_probe: unknown sweep {bad}; "
                         f"give decode and/or encode")
    ok = True
    try:
        if "decode" in which:
            ok &= sweep_decode()
        if "encode" in which:
            ok &= sweep_encode()
    finally:
        cuda_lib._LIB = None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
