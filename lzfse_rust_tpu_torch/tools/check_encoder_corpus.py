"""Byte-identity check of the encode path on the card.

    python3 -m lzfse_rust_tpu_torch.tools.check_encoder_corpus

Port of the JAX package's ``tools/test_tpu_encoder_corpus.py`` (renamed so
that it is not taken for a test). ``TorchEncoder("cuda")`` must write
exactly ``native.encode_bytes``'s container for every input:
``encode_many`` over the seeded serving batch's raw inputs and over a
small mixed batch, and ``encode_bytes`` on the largest input of each
corpus kind; every output must also decode back to its input
(``native.decode_bytes``). Exits 1 on any mismatch.
"""

from __future__ import annotations

import sys
import time

from ..runtime.build import native_runtime
from ..utils import corpus as CP
from .common import require_card, serving_pairs


def check(name: str, raws, got) -> int:
    native = native_runtime()
    bad = 0
    for i, (raw, out) in enumerate(zip(raws, got)):
        same = out == native.encode_bytes(raw)
        back = native.decode_bytes(out) == raw
        if not (same and back):
            print(f"MISMATCH {name}[{i}] ({len(raw)} B): identical={same} "
                  f"round_trip={back}", flush=True)
            bad += 1
    print(f"{name}: {len(raws)} inputs checked, {bad} mismatches",
          flush=True)
    return bad


def main(argv=None) -> int:
    from .. import TorchEncoder
    require_card("check_encoder_corpus")
    enc = TorchEncoder("cuda")
    serving = [r for r, _ in serving_pairs()]
    small = [r for r, _ in CP.small_batch(seed=1)]
    bad = check("serving encode_many", serving, enc.encode_many(serving))
    bad += check("small encode_many", small, enc.encode_many(small))
    for kind in CP.KINDS:
        raw = max((r for r, _ in CP.kind_batch(kind, seed=11,
                                               min_bytes=4 << 20)), key=len)
        t = time.perf_counter()
        out = enc.encode_bytes(raw)
        dt = time.perf_counter() - t
        bad += check(f"encode_bytes {kind} ({dt * 1e3:.1f} ms)", [raw], [out])
    print("ALL", "OK" if not bad else "MISMATCH", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
