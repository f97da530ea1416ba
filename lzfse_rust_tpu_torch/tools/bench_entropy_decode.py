"""The entropy stage with its decode tables built on the card or on the
host, on the serving batch.

    python3 -m lzfse_rust_tpu_torch.tools.bench_entropy_decode

Port of the JAX package's ``tools/bench_entropy_decode.py``, which timed
the device table build (``build_decode_tables_v3``) with both decode
kernels. Here the same two ways of getting the kernels' tables are timed
side by side, each followed by both decode kernels (``csrc/fse_decode.cu``)
on the inputs ``decode_many`` builds:

* device: ``ops/table_build.build_decode_tables_v3`` (torch ops on the
  card) from the blocks' weights, then a row gather into the kernels'
  size-sorted slots; the mean of 10 runs between CUDA events;
* host: ``native.build_tables3_batch`` straight into the slots (what
  ``decode_many``'s ``prep_tables`` runs); the second-smallest of 9 runs.

The tables built on the card must equal the host's, word for word. Prints
a ``torch.profiler`` table of the device build, then
raw bytes of the batch per second of each entropy stage; the last line is
one JSON object.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..ops import cuda_decode as K
from ..ops import table_build as TB
from ..runtime.build import native_runtime
from ..utils.timing import _Clock, cuda_ms
from .common import require_card, second_smallest, serving_pairs


def slot_inputs(dec, sources):
    """(weights (nb, 360) uint16 in block order, literal slot of each block,
    L/M/D slot of each block, literal kwargs, L/M/D kwargs) as
    ``decode_many`` builds them."""
    w16 = native_runtime().walk_batch(sources)[1]
    _, (batch, *_rest) = dec._front(sources, None, _Clock(None))
    return w16, batch.sl_n, batch.sm_n, batch.lit[0], batch.lmd[0]


def device_tables(weights: torch.Tensor, perm_l: torch.Tensor,
                  perm_m: torch.Tensor):
    """The kernels' (u3, tot, v) in slot order, built on the weights'
    device."""
    v, u3, tot = TB.build_decode_tables_v3(weights)
    return u3[perm_l], tot[perm_l], v[perm_m]


def profile_tables(weights, perm_l, perm_m) -> str:
    """``torch.profiler`` table of three device table builds, the top ops
    by CUDA time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            device_tables(weights, perm_l, perm_m)
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=12)


def main(argv=None) -> int:
    from .. import TorchDecoder
    card = require_card("bench_entropy_decode")
    pairs = serving_pairs()
    raw = sum(len(r) for r, _ in pairs)
    dec = TorchDecoder("cuda")
    sources = [c for _, c in pairs]
    w16, sl_n, sm_n, lit, lmd = slot_inputs(dec, sources)
    nb = len(w16)
    perm_l = torch.from_numpy(np.argsort(sl_n)).cuda()
    perm_m = torch.from_numpy(np.argsort(sm_n)).cuda()
    weights = torch.from_numpy(w16.astype(np.int32)).cuda()
    u3, tot, v = device_tables(weights, perm_l, perm_m)
    same = (torch.equal(u3, lit["tables"]) and torch.equal(tot, lit["tot"])
            and torch.equal(v, lmd["tables"]))
    if not same:
        raise RuntimeError("tables built on the card differ from the host's")
    tables_ms = cuda_ms(lambda: device_tables(weights, perm_l, perm_m),
                        reps=10, warmup=2)
    print(profile_tables(weights, perm_l, perm_m), flush=True)
    kernels_ms = cuda_ms(lambda: (K.decode_literals(**lit),
                                  K.decode_lmds(**lmd)), reps=10, warmup=2)

    def dev_stage():
        t_u3, t_tot, t_v = device_tables(weights, perm_l, perm_m)
        K.decode_literals(**{**lit, "tables": t_u3, "tot": t_tot})
        K.decode_lmds(**{**lmd, "tables": t_v})

    device_ms = cuda_ms(dev_stage, reps=10, warmup=2)
    v_h = np.zeros((nb, 384), np.int32)
    u_h = np.zeros((nb, 384), np.int32)
    t_h = np.zeros(nb, np.int32)
    w = np.ascontiguousarray(w16)
    host = []
    for _ in range(9):
        t = time.perf_counter()
        native_runtime().build_tables3_batch(w, sm_n, sl_n, v_h, u_h, t_h)
        host.append(time.perf_counter() - t)
    host_ms = second_smallest(host) * 1e3
    if not (np.array_equal(u_h, lit["tables"].cpu().numpy())
            and np.array_equal(v_h, lmd["tables"].cpu().numpy())):
        raise RuntimeError("host tables differ from decode_many's")
    s = {"card": card, "blocks": nb, "raw_bytes": raw,
         "device_tables_ms": tables_ms, "host_tables_ms": host_ms,
         "kernels_ms": kernels_ms, "device_stage_ms": device_ms,
         "device_GBps": raw / device_ms / 1e6,
         "host_tables_then_kernels_GBps": raw / (host_ms + kernels_ms) / 1e6}
    print(f"{nb} blocks: tables on the card {tables_ms:.4f} ms (equal to the "
          f"host's), on the host {host_ms:.4f} ms; both kernels "
          f"{kernels_ms:.4f} ms; card tables + kernels {device_ms:.4f} ms = "
          f"{s['device_GBps']:.3f} GB/s of raw bytes; host tables + kernels "
          f"{host_ms + kernels_ms:.4f} ms = "
          f"{s['host_tables_then_kernels_GBps']:.3f} GB/s", flush=True)
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
