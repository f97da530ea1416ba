"""Bit-exactness check of the decode path on the card.

    python3 -m lzfse_rust_tpu_torch.tools.check_corpus

Port of the JAX package's ``tools/check_corpus_tpu.py``.
``TorchDecoder("cuda").decode_many`` decodes the seeded serving batch and
a small mixed batch (LZVN, RAW and empty containers among them); every
output must equal ``native.decode_bytes`` of the same container, and no
container may take the spec-layer fallback (the device path must run, not
be bypassed). Exits 1 on any mismatch or fallback.
"""

from __future__ import annotations

import hashlib
import sys

from ..runtime.build import native_runtime
from ..utils import corpus as CP
from .common import require_card, serving_pairs


def check(dec, name: str, sources) -> int:
    """Mismatches plus fallbacks of one batch, each mismatch printed."""
    native = native_runtime()
    stats: dict = {}
    got = dec.decode_many(sources, stats)
    bad = 0
    for i, (src, out) in enumerate(zip(sources, got)):
        want = native.decode_bytes(src)
        if want != out:
            print(f"MISMATCH {name}[{i}]: want {len(want)} B "
                  f"{hashlib.sha256(want).hexdigest()[:12]}, got {len(out)} "
                  f"B {hashlib.sha256(out).hexdigest()[:12]}", flush=True)
            bad += 1
    fb = stats.get("fallbacks", 0)
    print(f"{name}: {len(sources)} containers checked, {bad} mismatches, "
          f"{fb} fallbacks", flush=True)
    return bad + fb


def main(argv=None) -> int:
    from .. import TorchDecoder
    require_card("check_corpus")
    dec = TorchDecoder("cuda")
    bad = check(dec, "serving", [c for _, c in serving_pairs()])
    bad += check(dec, "small", [c for _, c in CP.small_batch(seed=1)])
    print("ALL", "OK" if not bad else "FAILED", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
