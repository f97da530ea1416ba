"""Time both decode kernels at 32, 64, 128 and 256 threads per CUDA block.

    python3 -m lzfse_rust_tpu_torch.tools.block_size_probe

Needs an NVIDIA GPU. It builds one variant of ``csrc/fse_decode.cu`` per
block size (into ``build/probe<T>/``), runs each on the kernel inputs of
the seeded serving batch that ``chip_smoke.py`` decodes, checks its
outputs bit for bit against the shipped build, and prints CUDA-event
times in two rounds of opposite order. Exits 1 if a variant disagrees.
"""

from __future__ import annotations

import sys

import torch

from ..ops import cuda_decode as K
from ..runtime import build as B, cuda_lib
from ..utils import corpus as CP
from ..utils.timing import cuda_ms
from .common import require_card

SIZES = (32, 64, 128, 256)
SHIPPED = "constexpr int kThreads = 128;"


def variant(threads: int):
    """The kernel library built with ``threads`` threads per CUDA block."""
    src = (B.CSRC / "fse_decode.cu").read_text()
    if SHIPPED not in src:
        raise RuntimeError(f"{SHIPPED!r} not found in fse_decode.cu")
    d = B.BUILD_DIR / f"probe{threads}"
    d.mkdir(parents=True, exist_ok=True)
    cu = d / "fse_decode.cu"
    cu.write_text(src.replace(SHIPPED, f"constexpr int kThreads = {threads};"))
    # the other sources as shipped: the library must hold every entry point
    rest = [s for s in sorted(B.CSRC.glob("*.cu")) if s.name != cu.name]
    return cuda_lib.load(B.kernel_library(d / "lib.so", [cu, *rest]))


def main(argv=None) -> int:
    from .. import TorchDecoder
    require_card("block_size_probe")
    libs = {t: variant(t) for t in SIZES}
    pairs = CP.serving_batch(seed=0)
    lit, lmd = TorchDecoder("cuda").kernel_args([c for _, c in pairs])
    print(f"{lit['tables'].shape[0]} streams", flush=True)
    want = (K.decode_literals(**lit), K.decode_lmds(**lmd))   # shipped build
    torch.cuda.synchronize()
    ok = True
    for rnd, order in enumerate((SIZES, SIZES[::-1])):
        for t in order:
            cuda_lib._LIB = libs[t]
            got = (K.decode_literals(**lit), K.decode_lmds(**lmd))
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for gs, ws in zip(got, want)
                       for g, w in zip(gs, ws))
            ok &= same
            lit_ms = cuda_ms(lambda: K.decode_literals(**lit), reps=10,
                             warmup=2)
            lmd_ms = cuda_ms(lambda: K.decode_lmds(**lmd), reps=10, warmup=2)
            print(f"round {rnd} threads/block {t}: literal {lit_ms:.4f} ms, "
                  f"lmd {lmd_ms:.4f} ms, same={same}", flush=True)
    cuda_lib._LIB = None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
