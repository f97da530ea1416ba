"""Per-kind rows of the public API's engines: the host's one-shot, ring
and thread-pool engines beside the batch entry points on the card.

    python3 -m lzfse_rust_tpu_torch.tools.bench_corpus [MIB_PER_KIND]

Port of the JAX package's ``tools/bench_corpus.py``. That tool timed each
Snappy-corpus file through the native one-shot and ring engines and wrote
its table into PERF.md; those files are not in the repository, so each row
here is one kind of ``utils/corpus.KINDS``, seeded, ``MIB_PER_KIND``
(default 24, the size of ``utils/corpus.kind_batch`` and
``bench_per_file``) MiB of raw bytes in containers of 16 KiB to 4 MiB,
and the
table is printed, not written anywhere. Per kind, every container must
round-trip and the API's ``encode_bytes`` must equal the corpus container
(the native encoder's); then, each the second-smallest of ``RUNS`` timed
passes over the kind's containers:

* ``encode_bytes`` / ``decode_bytes`` one container at a time (one-shot);
* ``LzfseRingEncoder.encode`` / ``LzfseRingDecoder.decode`` over
  ``io.BytesIO`` (ring);
* ``encode_many`` / ``decode_many`` with ``device="cpu"`` (the host
  thread pool);
* ``encode_many`` / ``decode_many`` on the card (the default device: one
  ``TorchEncoder`` / ``TorchDecoder`` call), the containers equal to the
  corpus's and the outputs SHA-checked, the decoder with no fallback.

One JSON line per kind, then a table.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import time

import torch

from ..utils import corpus as CP
from .common import require_card, second_smallest

RUNS = 3


def _wall(fn) -> float:
    """Seconds of one call of ``fn``."""
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def _ring_encode(api, raw: bytes) -> bytes:
    sink = io.BytesIO()
    api.LzfseRingEncoder().encode(io.BytesIO(raw), sink)
    return sink.getvalue()


def _ring_decode(api, blob: bytes) -> bytes:
    sink = io.BytesIO()
    api.LzfseRingDecoder().decode(io.BytesIO(blob), sink)
    return sink.getvalue()


def measure(kind: str, seed: int, min_bytes: int) -> dict:
    """One kind's row: MB/s of each engine over the kind's batch."""
    from .. import api
    pairs = CP.kind_batch(kind, seed=seed, min_bytes=min_bytes)
    raws = [r for r, _ in pairs]
    blobs = [c for _, c in pairs]
    raw = sum(map(len, raws))
    for r, c in pairs:
        if api.encode_bytes(r) != c or api.decode_bytes(c) != r:
            raise RuntimeError(f"{kind}: a container differs from the "
                               f"native encoder's or does not round-trip")
        if _ring_decode(api, _ring_encode(api, r)) != r:
            raise RuntimeError(f"{kind}: a ring round trip differs")
    st: dict = {}
    outs = api._card("decode", torch.device("cuda"))[0].decode_many(blobs, st)
    if st.get("fallbacks", 0):
        raise RuntimeError(f"{kind}: {st['fallbacks']} containers fell "
                           f"back to the spec layer on the card")
    want = [hashlib.sha256(r).digest() for r in raws]
    for got in (outs, api.decode_many(blobs)):
        if [hashlib.sha256(o).digest() for o in got] != want:
            raise RuntimeError(f"{kind}: a card decode differs")
    if api.encode_many(raws) != blobs:
        raise RuntimeError(f"{kind}: a card container differs")

    engines = {
        "one_shot_encode": lambda: [api.encode_bytes(r) for r in raws],
        "one_shot_decode": lambda: [api.decode_bytes(c) for c in blobs],
        "ring_encode": lambda: [_ring_encode(api, r) for r in raws],
        "ring_decode": lambda: [_ring_decode(api, c) for c in blobs],
        "host_encode_many": lambda: api.encode_many(raws, device="cpu"),
        "host_decode_many": lambda: api.decode_many(blobs, device="cpu"),
        "card_encode_many": lambda: api.encode_many(raws),
        "card_decode_many": lambda: api.decode_many(blobs),
    }
    row = {"kind": kind, "containers": len(pairs), "raw_bytes": raw,
           "compressed_bytes": sum(map(len, blobs))}
    for name, fn in engines.items():
        fn()   # warm-up
        row[f"{name}_MBps"] = raw / second_smallest(
            [_wall(fn) for _ in range(RUNS)]) / 1e6
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    require_card("bench_corpus")
    min_bytes = int(argv[0]) << 20 if argv else 24 << 20
    rows = []
    for k, kind in enumerate(CP.KINDS):
        row = measure(kind, k, min_bytes)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print("\n| kind | containers | raw MB | ratio | one-shot enc / dec MB/s "
          "| ring enc / dec MB/s | host encode_many / decode_many MB/s "
          "| card encode_many / decode_many MB/s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['kind']} | {r['containers']} | {r['raw_bytes'] / 1e6:.1f} "
              f"| {r['compressed_bytes'] / r['raw_bytes']:.3f} "
              f"| {r['one_shot_encode_MBps']:.1f} / "
              f"{r['one_shot_decode_MBps']:.1f} "
              f"| {r['ring_encode_MBps']:.1f} / {r['ring_decode_MBps']:.1f} "
              f"| {r['host_encode_many_MBps']:.1f} / "
              f"{r['host_decode_many_MBps']:.1f} "
              f"| {r['card_encode_many_MBps']:.1f} / "
              f"{r['card_decode_many_MBps']:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
