"""The decode device stage taken apart: the upload, the literal kernel and
the L/M/D kernel, each timed alone with CUDA events.

    python3 -m lzfse_rust_tpu_torch.tools.bench_stage_split

Port of the JAX package's ``tools/bench_stage_split.py`` and
``tools/bench_entropy_decode.py`` on the seeded serving batch. The upload
is the copy ``TorchDecoder`` makes: the pinned host staging buffer
(payloads, tables, states and per-block rows) to the card in one
``non_blocking`` copy. The literal and L/M/D kernels (``csrc/fse_decode.cu``)
run on the inputs ``decode_many`` builds, decode tables included
(``native.build_tables3_batch`` on the host). Each stage is the mean of 10
runs after 2 warm-ups. The entropy stage here is the two kernels alone;
``bench_entropy_decode`` times them with the device decode-table build
(``build_decode_tables_v3``), as the JAX tool did. Prints symbols
per second of each kernel and raw bytes of the batch per second of the
entropy stage and of the whole device stage; the last line is one JSON
object.
"""

from __future__ import annotations

import json
import sys

from ..ops import cuda_decode as K
from ..utils.timing import cuda_ms
from .common import decode_inputs, require_card


def upload_source(dec, lit):
    """The host staging buffer's words that ``decode_many`` uploads (its
    device copy backs every kernel argument)."""
    n_words = lit["words"].untyped_storage().nbytes() // 4
    return dec._stage[:n_words]


def summary(stages: dict, n_lit: int, n_lmd: int, raw: int,
            upload_bytes: int) -> dict:
    """Rates of the stages' milliseconds: Msym/s of each kernel, GB/s of
    raw bytes of the entropy stage (both kernels) and of all stages, GB/s
    of the upload."""
    entropy = stages["literals"] + stages["lmds"]
    return {"stages_ms": stages, "raw_bytes": raw,
            "upload_bytes": upload_bytes,
            "literal_Msym_s": n_lit / stages["literals"] / 1e3,
            "lmd_Msym_s": n_lmd / stages["lmds"] / 1e3,
            "entropy_GBps": raw / entropy / 1e6,
            "total_GBps": raw / sum(stages.values()) / 1e6,
            "upload_GBps": upload_bytes / stages["upload"] / 1e6}


def main(argv=None) -> int:
    require_card("bench_stage_split")
    dec, _, lit, lmd, raw = decode_inputs()
    host = upload_source(dec, lit)
    stages = {
        "upload": cuda_ms(lambda: host.to("cuda", non_blocking=True),
                          reps=10, warmup=2),
        "literals": cuda_ms(lambda: K.decode_literals(**lit), reps=10,
                            warmup=2),
        "lmds": cuda_ms(lambda: K.decode_lmds(**lmd), reps=10, warmup=2),
    }
    n_lit = int(lit["num"].sum())
    n_lmd = int(lmd["num"].sum())
    s = summary(stages, n_lit, n_lmd, raw, host.numel() * 4)
    print(f"B={lit['tables'].shape[0]} raw={raw} lit_syms={n_lit} "
          f"lmd_syms={n_lmd} upload_bytes={s['upload_bytes']}", flush=True)
    for name, ms in stages.items():
        print(f"{name:12s} {ms:9.4f} ms", flush=True)
    print(f"literal kernel {s['literal_Msym_s']:.1f} Msym/s; L/M/D kernel "
          f"{s['lmd_Msym_s']:.1f} Msym/s; entropy decode "
          f"{s['entropy_GBps']:.4f} GB/s of raw bytes; upload "
          f"{s['upload_GBps']:.2f} GB/s; all stages {s['total_GBps']:.4f} "
          f"GB/s of raw bytes", flush=True)
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
