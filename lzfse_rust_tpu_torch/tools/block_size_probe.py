"""Time both decode kernels at 4, 8, 16 and 32 streams per CUDA block.

    python3 -m lzfse_rust_tpu_torch.tools.block_size_probe

Needs an NVIDIA GPU. It builds one variant of ``csrc/fse_decode.cu`` per
streams-per-block count (``kStreams``, the kernels' one tuning constant;
into ``build/probe<S>/``), runs each on the kernel inputs of the seeded
serving batch that ``chip_smoke.py`` decodes, checks its outputs bit for
bit against the shipped build, and prints CUDA-event times in two rounds of
opposite order: each kernel alone, and ``kernels_ms`` of a whole
``decode_many`` (both kernels side by side on two CUDA streams; the median
of three calls). Exits 1 if a variant disagrees.
"""

from __future__ import annotations

import sys

import torch

from ..ops import cuda_decode as K
from ..runtime import build as B, cuda_lib
from ..utils import corpus as CP
from ..utils.timing import cuda_ms
from .common import require_card

SIZES = (4, 8, 16, 32)


def variant_source(src: str, streams: int) -> str:
    """``fse_decode.cu`` with ``streams`` streams per CUDA block."""
    K.streams_per_block(src)   # exactly one line to rewrite
    return K.STREAMS_LINE.sub(f"constexpr int kStreams = {streams};", src)


def library(name: str, source: str):
    """The kernel library built with ``source`` in place of
    ``fse_decode.cu`` (into ``build/<name>/``), loaded."""
    d = B.BUILD_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    cu = d / "fse_decode.cu"
    cu.write_text(source)
    # the other sources as shipped: the library must hold every entry point
    rest = [s for s in sorted(B.CSRC.glob("*.cu")) if s.name != cu.name]
    return cuda_lib.load(B.kernel_library(d / "lib.so", [cu, *rest]))


def variant(streams: int):
    """The kernel library built with ``streams`` streams per CUDA block."""
    return library(f"probe{streams}",
                   variant_source(K.SOURCE.read_text(), streams))


def main(argv=None) -> int:
    from .. import TorchDecoder
    require_card("block_size_probe")
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
    cuda_lib._LIB = None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
