#!/usr/bin/env python3
"""Drive the PyTorch port's serving decode (host and device rebuild), both encode frontends (with the chunked pipeline, the argsort branch and host emission), the multi-device paths, the public API and CLI, and the probes once on an NVIDIA GPU.

    python3 chip_smoke.py

It takes no arguments: the serving batch is always the full one. For a
quick check on the card after a kernel edit, run
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.

Phases, one line each; any failure exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.is_available()``;
2. build: the CUDA kernels (``csrc/*.cu`` -> ``build/liblzfse_torch_kernels.so``)
   and the native host runtime (-> ``build/libtpulzfse.so``), timed;
3. probes: every body of the three probe kernels (``csrc/probes.cu``, the
   TPU tools' op-mix microbenchmarks) must equal its plain PyTorch version
   bit for bit on seeded inputs at a short length (each timed with CUDA
   events); then the port's ``microbench_step`` (with ``--multisym``) and
   ``microbench_vpu`` rows run at the TPU tools' step counts;
4. corpus: a seeded serving batch from ``utils/corpus.py`` (at least
   128 MiB raw and 1,600 FSE blocks, containers of 16 KiB to 4 MiB plus
   LZVN, RAW and empty containers);
5. kernels: on the batch's own kernel inputs each CUDA kernel must equal its
   plain PyTorch version bit for bit (decode: every output word, final
   states and positions; encode: every defined push group and the final
   states; the grouped match finder: every compacted row and offset of
   every window, one launch per window size as the device frontend makes
   them; the LZ rebuild: every output byte and ok flag of the batch's
   flattened containers, with the open positions per round beside the plain
   version's); each timed with CUDA events, the two redesigned kernels
   beside their earlier designs' times, with registers and spills;
6. slice: ``TorchDecoder("cuda").decode_many`` twice (warm-up, timed); every
   output's SHA-256 must equal its raw input's, with no spec-layer fallback
   and both decode kernels launched; a small mixed batch must decode to its
   raw inputs;
6b. rebuild_device: ``TorchDecoder("cuda", use_native_rebuild=False)
   .decode_many`` twice on the same batch (warm-up, timed): the flatten and
   the LZ rebuild kernel (``csrc/lz_rebuild.cu``) on the card; every
   SHA-256 must match, no fallback, both decode kernels and the rebuild
   kernel launched; its stage split beside the default path's; then
   ``TorchDecoder("cuda", use_kernels=False, use_native_rebuild=False)``
   (the scan path: tables and scans as torch ops) on the small mixed batch,
   timed;
7. encode: ``TorchEncoder("cuda").encode_many`` on the batch's raw inputs
   twice (warm-up, timed); every output must equal its corpus container
   (made by the native encoder), with both encode kernels launched;
   ``encode_bytes`` must do the same on the largest and a small input;
8. encode_device: ``TorchEncoder("cuda", frontend="device").encode_many``
   on the small mixed batch (warm-up), then on the same raw inputs (timed):
   every output must equal its corpus container, with the grouped match
   kernel and both encode kernels launched; the stage split, the windows
   per size, the bytes up and down and the rate beside the native
   frontend's; ``encode_bytes`` on the largest and a small input;
8a. encode_host: ``TorchEncoder("cuda", device_emission=False)`` (host
   emission: the device windows' matches, then ``native.select_emit_fse``
   per source on host threads) on the small mixed batch (warm-up), then on
   the same raw inputs (timed): every output must equal its corpus
   container, ``last_emission`` must be ``"host"``, the grouped match
   kernel must launch and neither encode kernel; its stage split beside
   encode_device's from this run; ``encode_bytes`` on the largest input;
   then ``LZT_DEV_GROUPED=0`` with host emission on encode_argsort's cut;
8b. mesh: several devices (``parallel/mesh.py``), on every card when there
   are two or more, else on ``cuda:0`` four times (the shards take turns on
   the one card): ``parallel/dryrun.dryrun_multichip(4)`` on the card;
   ``sharded_pallas_entropy_decode`` must equal the unsharded decode
   kernels bit for bit on the batch's own kernel arguments;
   ``TorchDecoder("cuda", mesh=...).decode_many`` twice on the batch
   (warm-up, timed): every SHA-256 must match, no fallback, each decode
   kernel launched once a shard, its rate and per-shard kernel ms beside
   the single-device slice's; ``TorchEncoder("cuda", mesh=...)
   .encode_many`` once on the raw inputs: every container must equal its
   corpus container, the grouped match kernel launched once a shard for
   each window size; with two cards or more, ``tools/demo_multihost
   --device cuda --hosts 2`` (two processes over NCCL), else a line saying
   it was not run;
8c. api: the public API (``api.py``) on the serving batch, each batch
   entry point by its default route (the card, whose kernels must launch)
   and with ``device="cpu"`` (the host thread pool): ``decode_many`` must
   equal the raw inputs (SHA-256) and the slice phase's ``TorchDecoder``
   outputs, ``encode_many`` the corpus containers and the encode phase's
   ``TorchEncoder`` outputs; on the largest input the ring engines, the
   writer and the reader round trip; ``probe`` on every container; both
   routes' walls beside the batch engines' from this run;
8d. cli: ``python3 -m lzfse_rust_tpu_torch.cli -encode`` and ``-decode``
   as two processes, the first's output streamed into the second, on the
   largest raw input: SHA-exact, the stream between them equal to
   ``LzfseRingEncoder``'s;
8e. encode_chunks: ``TorchEncoder("cuda").encode_many`` with
   ``LZT_ENC_CHUNKS`` at 1, 2 and 4, in turns, three timed runs each after
   a warm-up: every container equal to its corpus container,
   ``pipeline_chunks`` the count and each encode kernel launched once a
   chunk (counts set to 0 before each run); walls and stage splits
   beside the encode phase's;
8f. encode_argsort: ``TorchEncoder("cuda", frontend="device")`` with
   ``LZT_DEV_GROUPED=0`` (``find_matches_compact`` as torch ops on the
   card) on a cut of the batch, the smallest source with a window of
   each window size (the host merge takes about a minute on the whole
   batch): every container equal to its corpus container, each encode
   kernel launched once; then the grouped path and the argsort branch in
   turns on the same cut, the walls and match stages of both;
9. the kernels' JSON line (all nine, each with its time, its plain
   version's time and its bound: the larger of the bytes it must move over
   the card's memory rate and its operations over the card's peak rate,
   counted from this run's inputs), then the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Each path's launch counts are set to 0 just before its timed run and read
just after; the kernel comparisons' launches do not count.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
MIN_FSE_BLOCKS = 1600   # FSE blocks in flight, as in the reference's bench

KERNELS = (
    # name (= wrapper; plain version name + "_ref"), CUDA source, TPU kernel
    # it replaces
    ("decode_literals", "lzfse_rust_tpu_torch/csrc/fse_decode.cu",
     "lzfse_rust_tpu/ops/pallas_decode.py:621"),
    ("decode_lmds", "lzfse_rust_tpu_torch/csrc/fse_decode.cu",
     "lzfse_rust_tpu/ops/pallas_decode.py:702"),
    ("encode_literals", "lzfse_rust_tpu_torch/csrc/fse_encode.cu",
     "lzfse_rust_tpu/ops/pallas_encode.py:242"),
    ("encode_lmds", "lzfse_rust_tpu_torch/csrc/fse_encode.cu",
     "lzfse_rust_tpu/ops/pallas_encode.py:291"),
)
MATCH = ("match_grouped", "lzfse_rust_tpu_torch/csrc/match_find.cu",
         "lzfse_rust_tpu/ops/match_find_tpu.py:194")
REBUILD = ("lz_rebuild", "lzfse_rust_tpu_torch/csrc/lz_rebuild.cu",
           "lzfse_rust_tpu/ops/lz_rebuild.py:50")
PROBES = (
    ("probe_step", "lzfse_rust_tpu_torch/csrc/probes.cu",
     "tools/microbench_step.py:38"),
    ("probe_chain", "lzfse_rust_tpu_torch/csrc/probes.cu",
     "tools/microbench_vpu.py:36"),
    ("probe_tput", "lzfse_rust_tpu_torch/csrc/probes.cu",
     "tools/microbench_vpu.py:112"),
)
CHECK_STEPS = {"probe_step": 64, "probe_chain": 16, "probe_tput": 16}
MESH_ON_ONE_CARD = 4   # shards of the mesh phase when there is one card

# The bound of a kernel (H100 SXM datasheet peak rates):
# bytes at the device memory rate, operations at the 32-bit rate outside the
# tensor cores (the table's float32 row stands for the 32-bit integer ops
# these kernels do). A codec kernel does at least OPS_PER_SYMBOL operations
# per symbol it codes (table lookup, bit shift, mask, add, position update);
# a probe body at least one per element of its tile per op of its step.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_SYMBOL = 5
# the grouped match finder: at least a dozen operations a slot for the
# arbitration, and 4 (two shifts, an or, a xor) per 8-byte word compared
MATCH_OPS_PER_SLOT = 12
MATCH_OPS_PER_WORD = 4
# the earlier designs of the two kernels redesigned since, as their own
# tools timed them at commit 7e245da on the H100 80GB HBM3 at 700 W, in the
# same call as the redesigns (bench_rebuild, bench_match_find): lz_rebuild's
# kernel, and match_grouped's six launches with their full outputs (47 bytes
# a slot) plus the download of every slot's key and winner (its gather of
# the saturated slots' columns not counted), printed beside this run's times
EARLIER_MS = {"lz_rebuild": 9.813, "match_grouped": 8.969 + 43.622}
# the LZ rebuild: at least a compare, a select and an index computation per
# output position
REBUILD_OPS_PER_POSITION = 3
PROBE_OPS_PER_STEP = {"probe_step": 1, "probe_chain": 32, "probe_tput": 16}


class PhaseError(RuntimeError):
    pass


def phase(name: str, ok: bool, detail: str) -> None:
    print(f"[{name}] {'PASS' if ok else 'FAIL'}: {detail}", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {detail}")


def card() -> str:
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip() or f"nvidia-smi: exit {smi.returncode}",
              flush=True)
    except FileNotFoundError:
        print("nvidia-smi: not found", flush=True)
    phase("card", torch.cuda.is_available(),
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return torch.cuda.get_device_name(0)


def build() -> None:
    from lzfse_rust_tpu_torch.runtime import build as B
    for what, fn in (("CUDA kernels", B.build_kernels),
                     ("native runtime", B.build_native)):
        t = time.perf_counter()
        path = fn()
        phase("build", path.exists(),
              f"{what}: {time.perf_counter() - t:.2f} s -> "
              f"{path.relative_to(ROOT)}")


def corpus(seed: int):
    from lzfse_rust_tpu_torch.runtime.build import native_runtime
    from lzfse_rust_tpu_torch.utils import corpus as CP
    t = time.perf_counter()
    pairs = CP.serving_batch(seed=seed)
    sources = [c for _, c in pairs]
    n_fse = len(native_runtime().walk_batch(sources)[0])
    raw = sum(len(r) for r, _ in pairs)
    kinds = {}
    for c in sources:
        kinds[c[:4]] = kinds.get(c[:4], 0) + 1
    phase("corpus", raw >= CP.SERVING_BYTES and n_fse >= MIN_FSE_BLOCKS,
          f"{len(pairs)} containers, {raw} raw bytes, "
          f"{sum(len(c) for c in sources)} compressed, {n_fse} FSE blocks, "
          f"first magics {dict(sorted((k.decode(), v) for k, v in kinds.items()))}, "
          f"made in {time.perf_counter() - t:.1f} s")
    return pairs, n_fse


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """(least milliseconds, what bounds it) for moving ``n_bytes`` and
    doing ``n_ops`` on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def codec_work(name: str, args: dict, outs) -> tuple[int, int]:
    """(bytes, operations) a codec kernel needs on these arguments: every
    input read once (of the row inputs, only the words a stream or a row's
    steps use), every output written once (encode: the defined columns)."""
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    if name.startswith("decode"):
        words = int(args["word_len"].clamp(min=0).sum()) * 4
        small = _nbytes(*(v for k, v in args.items()
                          if k != "words" and hasattr(v, "numel")))
        num = args["num"].clamp(min=0).long()
        symbols = int(num.sum()) * (1 if name == "decode_literals" else 3)
        return small + words + _nbytes(*outs), symbols * OPS_PER_SYMBOL
    kind = name.split("_")[1]
    steps = int(KE.steps_of(kind, args["num"], 1 << 30).sum())
    rows = ("words",) if kind == "literals" else ("lm", "d")
    small = _nbytes(*(v for k, v in args.items() if k not in rows))
    lanes = 4 if kind == "literals" else 3
    # outputs: two words a step (group) and the final states
    n_out = steps * 2 * 4 + _nbytes(outs[2])
    return (small + steps * len(rows) * 4 + n_out,
            steps * lanes * OPS_PER_SYMBOL)


def longest_steps(name: str, args: dict) -> int:
    """Steps of the longest stream: the length of a codec kernel's chain."""
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    num = args["num"].long().clamp(min=0)
    if name == "decode_literals":
        return int(((num + 3) // 4).max())
    if name == "decode_lmds":
        return int(num.max())
    return int(KE.steps_of(name.split("_")[1], args["num"], 1 << 30).max())


def _event_ms(fn):
    """(result, CUDA-event milliseconds) of one call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def kernels(dec, enc, pairs) -> list[dict]:
    """Each kernel on the batch's own arguments against its plain version,
    both timed with CUDA events (the plain version once)."""
    import torch
    from lzfse_rust_tpu_torch.ops import cuda_decode as KD
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.utils.timing import cuda_ms
    lit, lmd = dec.kernel_args([c for _, c in pairs])
    e_lit, e_lmd = enc.kernel_args([r for r, _ in pairs])
    runs = (
        (KD, lit, lambda outs: outs, f"{lit['tables'].shape[0]} streams, "
         f"{lit['n_out']} output words"),
        (KD, lmd, lambda outs: outs, f"{lmd['tables'].shape[0]} streams, "
         f"{lmd['n_out']} output words"),
        (KE, e_lit, lambda outs: KE.defined_columns("literals", outs,
                                                    e_lit["num"]),
         f"{e_lit['num'].numel()} streams, "
         f"{int(KE.steps_of('literals', e_lit['num'], 1 << 30).sum())} groups"),
        (KE, e_lmd, lambda outs: KE.defined_columns("lmds", outs,
                                                    e_lmd["num"]),
         f"{e_lmd['num'].numel()} streams, "
         f"{int(KE.steps_of('lmds', e_lmd['num'], 1 << 30).sum())} groups"),
    )
    rows = []
    for (name, src, replaces), (mod, args, defined, shape) in zip(KERNELS,
                                                                  runs):
        fn, ref = getattr(mod, name), getattr(mod, name + "_ref")
        got = defined(fn(**args))
        want, plain_ms = _event_ms(lambda: ref(**args))
        want = defined(want)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = cuda_ms(lambda: fn(**args), reps=10, warmup=2)
        n_bytes, n_ops = codec_work(name, args, got)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        phase("kernel", same and err == 0,
              f"{name}: {shape}, bit-exact={same}, max_abs_err={err}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({n_bytes} bytes, {n_ops} ops: "
              f"{bound_by}), longest stream {longest_steps(name, args)} "
              f"steps")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    return rows


def match_work(args: dict, rows, full) -> tuple[int, int]:
    """(bytes, operations) the grouped match finder with its compaction
    needs on these arguments: every input read once, the compacted rows and
    the offsets written once (``rows``, what ``match_rows`` returns); per
    slot the arbitration, and per set candidate bit the 8-byte words
    compared up to the first difference (from the LCPs of ``full``, the
    plain ``grouped_compact_ref``'s outputs). The same work whichever way
    it is done: the earlier design wrote every slot's outputs and left the
    compaction to a gather and the host."""
    cands, lcps = full[3], full[4]
    words = ((lcps.clamp(0, 63) >> 3) + 1)[cands >= 0]
    n_ops = (MATCH_OPS_PER_SLOT * args["pads"].numel()
             + MATCH_OPS_PER_WORD * int(words.sum()))
    return _nbytes(*args.values(), *rows), n_ops


def match_kernel(enc, pairs) -> dict:
    """The grouped match kernel against its plain version on every window
    of the batch's raw inputs, one launch per window size, as the device
    frontend launches it (the plain version takes one window at a time, so
    its (N, 64) byte windows fit the card); timed with CUDA events, the
    kernel with the read of its totals."""
    import torch
    from lzfse_rust_tpu_torch.ops import match_find as MF
    from lzfse_rust_tpu_torch.utils.timing import cuda_ms
    raws = [r for r, _ in pairs]
    wins = enc.windows(raws)
    ms = plain_ms = 0.0
    err, same, n_bytes, n_ops, slots = 0, True, 0, 0, 0
    n_m = n_s = 0
    for args in enc.match_args(raws, wins):
        got = MF.match_rows(**args, vn=False)
        want, p_ms = _event_ms(lambda: MF.match_rows_ref(**args, vn=False))
        eq = [g.shape == w.shape and torch.equal(g, w)
              for g, w in zip(got, want)]
        same &= all(eq)
        err = max([err] + [int((g.long() - w.long()).abs().max())
                           if g.shape == w.shape and g.numel() else -1
                           for g, w, e in zip(got, want, eq) if not e])
        ms += cuda_ms(lambda: MF.match_rows(**args, vn=False), reps=5,
                      warmup=1)
        plain_ms += p_ms
        full = MF.grouped_compact_ref(**args, vn=False)
        b, o = match_work(args, got, full)
        n_bytes, n_ops = n_bytes + b, n_ops + o
        slots += args["pads"].numel()
        n_m += got[1].shape[0]
        n_s += got[3].shape[0]
        del got, want, full
    bound_ms, bound_by = bound(n_bytes, n_ops)
    sizes = sorted({w[4] for w in wins})
    attrs = MF.kernel_attrs()
    phase("kernel", same and err == 0,
          f"{MATCH[0]}: {len(wins)} windows ({slots} slots, sizes {sizes}; "
          f"{n_m} matched, {n_s} saturated rows), bit-exact={same}, "
          f"max_abs_err={err}, kernel with compaction {ms:.4f} ms (earlier "
          f"design: kernel plus download and gather "
          f"{EARLIER_MS[MATCH[0]]:.4f} ms), plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({n_bytes} bytes, {n_ops} ops: {bound_by}); "
          f"{attrs['registers']} registers, {attrs['local_bytes']} local "
          f"(spill) bytes, {attrs['blocks_per_sm']} blocks an SM")
    return {"name": MATCH[0], "route": "cuda", "source": MATCH[1],
            "replaces": MATCH[2], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def rebuild_work(args: dict, n_out: int) -> tuple[int, int]:
    """(bytes, operations) the LZ rebuild needs on these arguments: every
    input read once (rows, literal pools, offsets, sizes), every output
    written once (a byte a position and the ok flags)."""
    n_bytes = _nbytes(*(v for v in args.values() if hasattr(v, "numel")))
    n_bytes += n_out + args["n_raw"].numel()
    return n_bytes, REBUILD_OPS_PER_POSITION * n_out


def rebuild_kernel(dec, pairs) -> dict:
    """The LZ rebuild kernel against its plain version on the serving
    batch's own flattened containers (all of them: the plain version's
    int64 maps of 134.6 M positions fit the card), timed with CUDA
    events."""
    import torch
    from lzfse_rust_tpu_torch.ops import cuda_rebuild as CR
    from lzfse_rust_tpu_torch.utils.timing import cuda_ms
    args = dec.rebuild_args([c for _, c in pairs])
    after: dict = {}
    got = CR.lz_rebuild(**args, detail=after)
    want, plain_ms = _event_ms(lambda: CR.lz_rebuild_ref(**args))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(int((g.int() - w.int()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    n_ok = int(got[1].sum())
    del want
    before: dict = {}
    CR.lz_rebuild_ref(**args, detail=before)
    torch.cuda.empty_cache()
    print(f"[kernel] {REBUILD[0]}: positions still pointing at a parent, "
          f"before the first round and after each: the kernel "
          f"(in-row chains folded, in-tile links resolved) "
          f"{after['unresolved']}, {len(after['unresolved']) - 1} rounds "
          f"with work; plain pointer doubling over the whole map "
          f"{before['unresolved']}, {len(before['unresolved']) - 1} rounds",
          flush=True)
    ms = cuda_ms(lambda: CR.lz_rebuild(**args), reps=5, warmup=1)
    n_out = args["n_out"]
    n_bytes, n_ops = rebuild_work(args, n_out)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    attrs = "; ".join(f"{k} {a['registers']} registers, {a['local_bytes']} "
                      f"local (spill) bytes, {a['blocks_per_sm']} blocks an "
                      f"SM" for k, a in CR.kernel_attrs().items())
    phase("kernel", same and err == 0 and n_ok == args["n_raw"].numel(),
          f"{REBUILD[0]}: {args['n_raw'].numel()} containers ({n_ok} ok), "
          f"{args['rows'].shape[0]} rows, {args['literals'].numel()} "
          f"literals, {n_out} output bytes, bit-exact={same}, "
          f"max_abs_err={err}, kernel {ms:.4f} ms (earlier design "
          f"{EARLIER_MS[REBUILD[0]]:.4f} ms), plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({n_bytes} bytes, {n_ops} ops: "
          f"{bound_by}); {attrs}")
    return {"name": REBUILD[0], "route": "cuda", "source": REBUILD[1],
            "replaces": REBUILD[2], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from lzfse_rust_tpu_torch.ops import (cuda_decode, cuda_encode,
                                          cuda_probes, cuda_rebuild,
                                          match_find)
    cuda_decode.reset_launches()
    cuda_encode.reset_launches()
    cuda_probes.reset_launches()
    cuda_rebuild.reset_launches()
    match_find.reset_launches()


def probe_cases(seed: int):
    """(kernel, body, args) for every body of the three probe kernels: at
    the TPU tools' input ranges (one vreg) and at any int32 (two vregs)."""
    import numpy as np
    import torch
    from lzfse_rust_tpu_torch.ops import cuda_probes as P
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)

    def draw(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).cuda()

    for wide, nv in ((False, 1), (True, 2)):
        full = (i32.min, i32.max + 1)
        for body, tw in P.STEP_BODIES.items():
            yield "probe_step", body, (
                draw((8, P.G * tw), *(full if wide else (0, 1024))),
                draw((8, P.G * 256), *(full if wide else (0, i32.max))),
                draw((8 * nv, 128), *(full if wide else (0, 128))))
        for kernel, bodies in (("probe_chain", P.CHAIN_BODIES),
                               ("probe_tput", P.TPUT_BODIES)):
            for body in bodies:
                rng_ = full if wide else (0, 128)
                yield kernel, body, (draw((8, 1024), *rng_),
                                     draw((8, 128), *rng_))


def probes(seed: int) -> list[dict]:
    """Every probe body against its plain version, then the port's probe
    tools' rows as the probes' main path."""
    from lzfse_rust_tpu_torch.ops import cuda_probes as P
    from lzfse_rust_tpu_torch.tools import microbench_step as PS
    from lzfse_rust_tpu_torch.tools import microbench_vpu as PV
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "err": 0, "bodies": 0,
                   "bad": [], "bound": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
            for name, _, _ in PROBES}
    for kernel, body, args in probe_cases(seed):
        fn, ref = getattr(P, kernel), getattr(P, kernel + "_ref")
        n = CHECK_STEPS[kernel]
        fn(body, *args, n)   # warm-up: first launch of this body
        got, ms = _event_ms(lambda: fn(body, *args, n))
        want, plain_ms = _event_ms(lambda: ref(body, *args, n))
        err = int((got.long() - want.long()).abs().max())
        acc = sums[kernel]
        acc["ms"] += ms
        acc["plain_ms"] += plain_ms
        acc["err"] = max(acc["err"], err)
        acc["bodies"] += 1
        # each body case is a launch of its own, with its own bound
        n_bytes = _nbytes(*args, got)
        n_ops = n * args[-1].numel() * PROBE_OPS_PER_STEP[kernel]
        acc["bound"] += bound(n_bytes, n_ops)[0]
        acc["t_bytes"] += bound(n_bytes, 0)[0]
        acc["t_ops"] += bound(0, n_ops)[0]
        if err:
            acc["bad"].append(body)
    rows = []
    for name, src, replaces in PROBES:
        acc = sums[name]
        phase("probes", not acc["bad"],
              f"{name}: {acc['bodies']} body cases at {CHECK_STEPS[name]} "
              f"steps, bit-exact={not acc['bad']} {acc['bad'] or ''}, "
              f"max_abs_err={acc['err']}, kernels {acc['ms']:.4f} ms, "
              f"plain {acc['plain_ms']:.1f} ms")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": acc["err"], "ms": acc["ms"],
                     "plain_ms": acc["plain_ms"], "bound_ms": acc["bound"],
                     "bound_by": ("bytes" if acc["t_bytes"] >= acc["t_ops"]
                                  else "operations"),
                     "library_ms": None})
    reset_launches()
    t = time.perf_counter()
    for mod, rows_of in ((PS, PS.ROWS + PS.MULTISYM_ROWS), (PV, PV.ROWS)):
        for row in rows_of:
            print(f"[probes] {mod.report(mod.measure(row, seed))}",
                  flush=True)
    launches = dict(P.launches)
    phase("probes", all(n > 0 for n in launches.values()),
          f"{len(PS.ROWS) + len(PS.MULTISYM_ROWS) + len(PV.ROWS)} tool rows "
          f"at the TPU tools' step counts in {time.perf_counter() - t:.1f} s, "
          f"launches {launches}")
    for r in rows:
        r["launches"] = launches[r["name"]]
    return rows


def slice_run(dec, pairs) -> tuple[dict, tuple, list]:
    import torch
    from lzfse_rust_tpu_torch.ops import cuda_decode as K
    from lzfse_rust_tpu_torch.utils import corpus as CP
    sources = [c for _, c in pairs]
    raw_bytes = sum(len(r) for r, _ in pairs)
    warm: dict = {}
    dec.decode_many(sources, warm)
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    reset_launches()
    t = time.perf_counter()
    outs = dec.decode_many(sources, stats)
    wall = time.perf_counter() - t
    launches = dict(K.launches)
    bad = [i for i, ((raw, _), out) in enumerate(zip(pairs, outs))
           if hashlib.sha256(out).digest() != hashlib.sha256(raw).digest()]
    fallbacks = stats.get("fallbacks", 0) + warm.get("fallbacks", 0)
    split = {k: round(v * 1e3, 3) for k, v in stats.items()
             if isinstance(v, float)}
    detail = {k: round(v, 3) for k, v in stats.get("detail_device", {}).items()}
    prep = {k: round(v * 1e3, 3) for k, v in stats["detail_prep"].items()}
    phase("slice", not bad and fallbacks == 0
          and all(n > 0 for n in launches.values()),
          f"{len(outs)} containers, sha mismatches {len(bad)}, fallbacks "
          f"{fallbacks}, launches {launches}")
    print(f"[slice] stage split ms {split}; prep ms {prep}; device events ms "
          f"{detail}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"[slice] full decode {raw_bytes} bytes in {wall * 1e3:.3f} ms = "
          f"{raw_bytes / wall / 1e9:.4f} GB/s", flush=True)
    small = CP.small_batch(seed=1)
    got = dec.decode_many([c for _, c in small])
    phase("small", got == [r for r, _ in small],
          f"{len(small)} small mixed containers decode to their raw inputs")
    digests = [hashlib.sha256(out).digest() for out in outs]
    return launches, (split, detail, wall), digests


def rebuild_run(pairs, default) -> dict:
    """``decode_many`` with the flatten and the LZ rebuild on the card, on
    the serving batch (warm-up, timed), its stage split beside the default
    path's from this run; then the scan path on the small mixed batch."""
    import torch
    from lzfse_rust_tpu_torch import TorchDecoder
    from lzfse_rust_tpu_torch.ops import cuda_decode as KD
    from lzfse_rust_tpu_torch.ops import cuda_rebuild as CR
    from lzfse_rust_tpu_torch.utils import corpus as CP
    dec = TorchDecoder("cuda", use_native_rebuild=False)
    sources = [c for _, c in pairs]
    raw_bytes = sum(len(r) for r, _ in pairs)
    warm: dict = {}
    dec.decode_many(sources, warm)
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    reset_launches()
    t = time.perf_counter()
    outs = dec.decode_many(sources, stats)
    wall = time.perf_counter() - t
    launches = {**KD.launches, **CR.launches}
    bad = [i for i, ((raw, _), out) in enumerate(zip(pairs, outs))
           if hashlib.sha256(out).digest() != hashlib.sha256(raw).digest()]
    fallbacks = stats.get("fallbacks", 0) + warm.get("fallbacks", 0)
    phase("rebuild_device", not bad and fallbacks == 0
          and all(n > 0 for n in launches.values()),
          f"{len(outs)} containers, sha mismatches {len(bad)}, fallbacks "
          f"{fallbacks}, launches {launches}")
    split = {k: round(v * 1e3, 3) for k, v in stats.items()
             if isinstance(v, float)}
    detail = {k: round(v, 3) for k, v in stats["detail_device"].items()}
    d_split, d_detail, d_wall = default
    print(f"[rebuild_device] stage split ms {split} (default path, same "
          f"run: {d_split}); device events ms {detail} (default: "
          f"{d_detail}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"[rebuild_device] full decode {raw_bytes} bytes in "
          f"{wall * 1e3:.3f} ms = {raw_bytes / wall / 1e9:.4f} GB/s (default "
          f"path, same run: {d_wall * 1e3:.3f} ms = "
          f"{raw_bytes / d_wall / 1e9:.4f} GB/s); output download "
          f"{raw_bytes / detail['out_download_ms'] / 1e6:.2f} GB/s",
          flush=True)
    small = CP.small_batch(seed=1)
    scan = TorchDecoder("cuda", use_kernels=False, use_native_rebuild=False)
    before = CR.launches["lz_rebuild"]
    stats = {}
    t = time.perf_counter()
    got = scan.decode_many([c for _, c in small], stats)
    wall = time.perf_counter() - t
    phase("scan", got == [r for r, _ in small]
          and stats.get("fallbacks", 0) == 0
          and CR.launches["lz_rebuild"] == before + 1,
          f"use_kernels=False: {len(small)} small mixed containers "
          f"({sum(len(r) for r, _ in small)} bytes) decode to their raw "
          f"inputs in {wall * 1e3:.1f} ms; stage split ms "
          f"{ {k: round(v * 1e3, 1) for k, v in stats.items() if isinstance(v, float)} }")
    # B1 (the scans) computes what both decode kernels compute: its bound
    # is theirs on the same streams
    lit, lmd = TorchDecoder("cuda").kernel_args([c for _, c in small])
    work = [codec_work(name, args, fn(**args)) for name, args, fn in (
        ("decode_literals", lit, KD.decode_literals),
        ("decode_lmds", lmd, KD.decode_lmds))]
    n_bytes, n_ops = (sum(w[0] for w in work), sum(w[1] for w in work))
    print(f"[bounds] B1 decode_literals_batch + decode_lmds_batch (torch "
          f"ops) on the small batch's {lit['num'].numel()} blocks: the scan "
          f"path's prep stage {stats['prep'] * 1e3:.1f} ms (host clock, "
          f"tables included), bound {bound(n_bytes, n_ops)[0]:.6f} ms "
          f"({n_bytes} bytes, {n_ops} ops: "
          f"{bound(n_bytes, n_ops)[1]})", flush=True)
    return {"lz_rebuild": launches["lz_rebuild"]}


def tables_bound(pairs) -> None:
    """B3: the device decode-table build (``build_decode_tables_v3``, torch
    ops) on the serving batch's FSE blocks, timed with CUDA events, beside
    its bound: the weights read once, the tables written once, at least
    one operation per weight and per table word."""
    import torch
    from lzfse_rust_tpu_torch.ops import table_build as TB
    from lzfse_rust_tpu_torch.runtime.build import native_runtime
    from lzfse_rust_tpu_torch.utils.timing import cuda_ms
    w16 = native_runtime().walk_batch([c for _, c in pairs])[1]
    weights = torch.from_numpy(w16.astype("int32")).cuda()
    outs = TB.build_decode_tables_v3(weights)
    ms = cuda_ms(lambda: TB.build_decode_tables_v3(weights), reps=10,
                 warmup=2)
    n_bytes = _nbytes(weights, *outs)
    n_ops = weights.numel() + sum(o.numel() for o in outs)
    b_ms, by = bound(n_bytes, n_ops)
    print(f"[bounds] B3 build_decode_tables_v3 (torch ops) on the batch's "
          f"{weights.shape[0]} FSE blocks: {ms:.4f} ms (CUDA events, mean "
          f"of 10), bound {b_ms:.6f} ms ({n_bytes} bytes, {n_ops} ops: "
          f"{by})", flush=True)


def encode_run(enc, pairs) -> tuple[dict, float, tuple]:
    import torch
    from lzfse_rust_tpu_torch.ops import cuda_encode as K
    from lzfse_rust_tpu_torch.utils import corpus as CP
    # the bare b"bvx$" container is hand-made; every other one is the
    # native encoder's
    pairs = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in pairs]
    raw_bytes = sum(map(len, raws))
    enc.encode_many(raws)
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    reset_launches()
    t = time.perf_counter()
    outs = enc.encode_many(raws, stats)
    wall = time.perf_counter() - t
    launches = dict(K.launches)
    bad = [i for i, ((_, c), out) in enumerate(zip(pairs, outs)) if out != c]
    split = {k: round(v * 1e3, 3) for k, v in stats.items()
             if isinstance(v, float)}
    detail = {k: round(v, 3) for k, v in stats["detail_device"].items()}
    phase("encode", not bad and all(n > 0 for n in launches.values()),
          f"{len(outs)} sources, container mismatches {len(bad)}, "
          f"launches {launches}")
    print(f"[encode] stage split ms {split}; device events ms {detail}; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    dd = stats["detail_device"]
    print(f"[encode] upload {stats['upload_bytes']} bytes = "
          f"{stats['upload_bytes'] / dd['upload_ms'] / 1e6:.2f} GB/s; "
          f"download {stats['download_bytes']} bytes = "
          f"{stats['download_bytes'] / dd['download_ms'] / 1e6:.2f} GB/s",
          flush=True)
    print(f"[encode] full encode {raw_bytes} bytes in {wall * 1e3:.3f} ms = "
          f"{raw_bytes / wall / 1e9:.4f} GB/s", flush=True)
    encode_bytes_check("encode_bytes", enc, pairs)
    return launches, raw_bytes / wall / 1e9, (outs, split, wall)


def encode_bytes_check(name: str, enc, pairs) -> None:
    """``encode_bytes`` on the largest and the smallest input above 4 KiB
    must give their corpus containers."""
    big = max(pairs, key=lambda p: len(p[0]))
    small = min((p for p in pairs if len(p[0]) > 4096),
                key=lambda p: len(p[0]))
    phase(name, all(enc.encode_bytes(r) == c for r, c in (big, small)),
          f"encode_bytes on {len(big[0])} and {len(small[0])} bytes equals "
          f"the corpus containers")


def encode_device_run(enc, pairs, native_gbps: float) -> dict:
    """``encode_many`` with the device frontend on the batch's raw inputs:
    warm-up, then the timed run; launches of the grouped match kernel."""
    import torch
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.ops import match_find as MF
    from lzfse_rust_tpu_torch.utils import corpus as CP
    pairs = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in pairs]
    raw_bytes = sum(map(len, raws))
    # warm-up on the small mixed batch only (the mesh phase's encode takes
    # the time a full warm-up took)
    enc.encode_many([r for r, c in CP.small_batch(seed=1) if c != CP.EMPTY])
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    reset_launches()
    t = time.perf_counter()
    outs = enc.encode_many(raws, stats)
    wall = time.perf_counter() - t
    launches = {**MF.launches, **KE.launches}
    bad = [i for i, ((_, c), out) in enumerate(zip(pairs, outs)) if out != c]
    phase("encode_device", not bad and all(n > 0 for n in launches.values()),
          f"{len(outs)} sources, container mismatches {len(bad)}, "
          f"launches {launches}")
    split = {k: round(v * 1e3, 3) for k, v in stats.items()
             if isinstance(v, float)}
    det = stats["detail_match"]
    dev = {k: round(v, 3) for k, v in stats["detail_device"].items()}
    match_dev = {k: round(sum(d[k] for d in det), 3)
                 for k in ("upload_ms", "kernel_ms", "download_ms")}
    print(f"[encode_device] stage split ms {split}; match finder events ms "
          f"{match_dev}; emission events ms {dev}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    n_slots = sum(d["slots"] for d in det)
    n_sat = sum(d["sat"] for d in det)
    n_mat = sum(d["matched"] for d in det)
    print(f"[encode_device] windows per size "
          f"{ {d['N']: d['windows'] for d in det} }; slots {n_slots}, "
          f"saturated {n_sat} ({n_sat / n_slots:.4%}), matched {n_mat} "
          f"({n_mat / n_slots:.4%}); match finder upload / kernel with "
          f"compaction / download ms {match_dev['upload_ms']} / "
          f"{match_dev['kernel_ms']} / {match_dev['download_ms']}",
          flush=True)
    for d in det:
        print(f"[encode_device] N {d['N']}: {d['windows']} windows, up "
              f"{d['upload_bytes']} bytes in {d['upload_ms']:.3f} ms, kernel "
              f"{d['kernel_ms']:.3f} ms, down {d['download_bytes']} bytes in "
              f"{d['download_ms']:.3f} ms", flush=True)
    up = sum(d["upload_bytes"] for d in det)
    down = sum(d["download_bytes"] for d in det)
    print(f"[encode_device] match finder up {up} bytes = "
          f"{up / match_dev['upload_ms'] / 1e6:.2f} GB/s, down {down} bytes "
          f"= {down / match_dev['download_ms'] / 1e6:.2f} GB/s; emission up "
          f"{stats['upload_bytes']} bytes, down {stats['download_bytes']} "
          f"bytes", flush=True)
    print(f"[encode_device] full encode {raw_bytes} bytes in "
          f"{wall * 1e3:.3f} ms = {raw_bytes / wall / 1e9:.4f} GB/s "
          f"(native frontend, same run: {native_gbps:.4f} GB/s)", flush=True)
    encode_bytes_check("encode_device_bytes", enc, pairs)
    return {"match_grouped": launches["match_grouped"]}, split, wall


def encode_host_run(pairs, device_run: tuple) -> None:
    """``TorchEncoder("cuda", device_emission=False).encode_many`` on the
    batch's raw inputs: warm-up on the small mixed batch, then the timed
    run, beside the device frontend's ``(split, wall)`` from this run;
    ``encode_bytes`` on the largest input; then the argsort branch with
    host emission on ``argsort_cut``."""
    from lzfse_rust_tpu_torch import TorchEncoder
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.ops import match_find as MF
    from lzfse_rust_tpu_torch.utils import corpus as CP
    pairs = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in pairs]
    raw_bytes = sum(map(len, raws))
    enc = TorchEncoder("cuda", device_emission=False)
    enc.encode_many([r for r, c in CP.small_batch(seed=1) if c != CP.EMPTY])
    stats: dict = {}
    reset_launches()
    t = time.perf_counter()
    outs = enc.encode_many(raws, stats)
    wall = time.perf_counter() - t
    launches = {**MF.launches, **KE.launches}
    bad = sum(o != c for o, (_, c) in zip(outs, pairs))
    n_win = len(TorchEncoder.windows(raws))
    phase("encode_host", bad == 0 and enc.last_emission == "host"
          and launches["match_grouped"] > 0
          and not any(KE.launches.values())
          and "detail_device" not in stats,
          f"{len(outs)} sources, {n_win} windows, container mismatches "
          f"{bad}, last_emission {enc.last_emission!r}, launches {launches}")
    split = {k: round(v * 1e3, 3) for k, v in stats.items()
             if isinstance(v, float)}
    match_dev = {k: round(sum(d[k] for d in stats["detail_match"]), 3)
                 for k in ("upload_ms", "kernel_ms", "download_ms")}
    d_split, d_wall = device_run
    print(f"[encode_host] stage split ms {split}; match finder events ms "
          f"{match_dev}", flush=True)
    print(f"[encode_host] encode_device's stage split ms, same run: "
          f"{d_split}", flush=True)
    print(f"[encode_host] full encode {raw_bytes} bytes in "
          f"{wall * 1e3:.3f} ms = {raw_bytes / wall / 1e9:.4f} GB/s "
          f"(encode_device, same run: {d_wall * 1e3:.3f} ms = "
          f"{raw_bytes / d_wall / 1e9:.4f} GB/s)", flush=True)
    big = max(pairs, key=lambda p: len(p[0]))
    enc.last_emission = None
    t = time.perf_counter()
    same = enc.encode_bytes(big[0]) == big[1]
    phase("encode_host", same and enc.last_emission == "host",
          f"encode_bytes on {len(big[0])} bytes equals the corpus container "
          f"in {time.perf_counter() - t:.2f} s")
    sub, _ = argsort_cut(pairs)
    with env_var("LZT_DEV_GROUPED", "0"):
        reset_launches()
        t = time.perf_counter()
        got = enc.encode_many([r for r, _ in sub])
        cut_wall = time.perf_counter() - t
    launches = {**MF.launches, **KE.launches}
    phase("encode_host", all(o == c for o, (_, c) in zip(got, sub))
          and enc.last_emission == "host"
          and not any(launches.values()),
          f"LZT_DEV_GROUPED=0 on encode_argsort's cut ({len(sub)} sources): "
          f"every container == the corpus's, launches {launches}, "
          f"{cut_wall * 1e3:.3f} ms")


def mesh_devices() -> tuple[list, str]:
    """Every card when there are two or more, else ``cuda:0`` four times
    (one card standing in for four), with a note of which."""
    import torch
    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], f"all {n} cards"
    return ["cuda:0"] * MESH_ON_ONE_CARD, (
        f"one card, cuda:0 {MESH_ON_ONE_CARD} times: the shards take turns "
        f"on it")


def mesh_run(pairs, default) -> None:
    """The multi-device slice: the dry run, then the serving decode and the
    device-frontend encode with a mesh, then, with two cards or more, two
    processes over NCCL. ``default`` is the single-device slice's (stage
    split, device events, wall) from this run."""
    import torch
    from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
    from lzfse_rust_tpu_torch.ops import cuda_decode as KD
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.ops import match_find as MF
    from lzfse_rust_tpu_torch.parallel.dryrun import dryrun_multichip
    from lzfse_rust_tpu_torch.parallel.mesh import (
        make_mesh, sharded_pallas_entropy_decode)
    from lzfse_rust_tpu_torch.utils import corpus as CP
    devs, which = mesh_devices()
    mesh = make_mesh(devs)
    t = time.perf_counter()
    checked = dryrun_multichip(MESH_ON_ONE_CARD)
    phase("mesh", True, f"mesh of {mesh.size} ({which}); dryrun_multichip"
          f"({MESH_ON_ONE_CARD}) on the card: {checked} in "
          f"{time.perf_counter() - t:.1f} s")

    # the sharded decode kernels against the unsharded ones, on the batch's
    # own kernel arguments
    lit, lmd = TorchDecoder("cuda").kernel_args([c for _, c in pairs])
    arrays = KD.to_jax_decode_args(lit, lmd)
    import numpy as np
    B = lit["tables"].shape[0]
    pad = -B % mesh.size   # inert streams: no steps
    arrays = {k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
              for k, v in arrays.items()}
    n_lit = int(((lit["num"].long() + 3) // 4).max())
    n_lmd = int(lmd["num"].max())
    got = sharded_pallas_entropy_decode(mesh, arrays, n_lit, n_lmd)
    w_lit = KD.decode_literals(**KD.from_jax_decode_args(
        "literals", arrays["u3_tabs"], arrays["lit_words"],
        arrays["lit_states"], arrays["lit_pos"], arrays["lit_num"],
        arrays["lit_tot"], device="cuda"))
    w_lmd = KD.decode_lmds(**KD.from_jax_decode_args(
        "lmds", arrays["v_tabs"], arrays["lmd_words"], arrays["lmd_states"],
        arrays["lmd_pos"], arrays["lmd_num"], device="cuda"))
    want = (w_lit[0], w_lmd[0], w_lmd[1], w_lit[1], w_lit[2], w_lmd[2],
            w_lmd[3])
    same = all(torch.equal(g.cuda(), w) for g, w in zip(got, want))
    phase("mesh", same, f"sharded_pallas_entropy_decode over {mesh.size} "
          f"shards == the unsharded kernels on the batch's {B} streams of "
          f"each kind and {pad} inert ones ({want[0].numel()} literal words, "
          f"{want[1].numel()} L/M/D rows): bit-exact={same}")
    del got, want, w_lit, w_lmd, arrays, lit, lmd
    torch.cuda.empty_cache()

    # the serving decode with the mesh
    dec = TorchDecoder("cuda", mesh=mesh)
    sources = [c for _, c in pairs]
    raw_bytes = sum(len(r) for r, _ in pairs)
    warm: dict = {}
    dec.decode_many(sources, warm)
    stats: dict = {}
    reset_launches()
    t = time.perf_counter()
    outs = dec.decode_many(sources, stats)
    wall = time.perf_counter() - t
    launches = dict(KD.launches)
    bad = [i for i, ((raw, _), out) in enumerate(zip(pairs, outs))
           if hashlib.sha256(out).digest() != hashlib.sha256(raw).digest()]
    fallbacks = stats.get("fallbacks", 0) + warm.get("fallbacks", 0)
    phase("mesh", not bad and fallbacks == 0
          and all(n == mesh.size for n in launches.values()),
          f"TorchDecoder(mesh=) decode: {len(outs)} containers, sha "
          f"mismatches {len(bad)}, fallbacks {fallbacks}, launches "
          f"{launches} (mesh size {mesh.size})")
    det = stats["detail_device"]
    d_split, d_detail, d_wall = default
    print(f"[mesh] decode {raw_bytes} bytes in {wall * 1e3:.3f} ms = "
          f"{raw_bytes / wall / 1e9:.4f} GB/s (single device, same run: "
          f"{d_wall * 1e3:.3f} ms = {raw_bytes / d_wall / 1e9:.4f} GB/s); "
          f"per-shard kernel ms {[round(x, 4) for x in det['shard_kernels_ms']]}"
          f", kernels span {det['kernels_ms']:.4f} ms (single device "
          f"{d_detail['kernels_ms']:.4f}), upload {det['upload_ms']:.4f} ms, "
          f"gather (download) {det['download_ms']:.4f} ms (single device "
          f"{d_detail['upload_ms']:.4f} / {d_detail['download_ms']:.4f}); "
          f"stage split ms { {k: round(v * 1e3, 3) for k, v in stats.items() if isinstance(v, float)} }",
          flush=True)

    # the device-frontend encode with the mesh, once
    pairs_e = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in pairs_e]
    enc = TorchEncoder("cuda", mesh=mesh)
    stats = {}
    reset_launches()
    t = time.perf_counter()
    outs = enc.encode_many(raws, stats)
    wall = time.perf_counter() - t
    launches = {**MF.launches, **KE.launches}
    n_sizes = len(stats["detail_match"])
    bad = [i for i, ((_, c), out) in enumerate(zip(pairs_e, outs))
           if out != c]
    phase("mesh", not bad and enc.frontend == "device"
          and launches["match_grouped"] == n_sizes * mesh.size
          and all(n > 0 for n in launches.values()),
          f"TorchEncoder(mesh=) encode: {len(outs)} sources, container "
          f"mismatches {len(bad)}, launches {launches} ({n_sizes} window "
          f"sizes x mesh size {mesh.size})")
    dm = stats["detail_match"]
    print(f"[mesh] encode {sum(map(len, raws))} bytes in {wall * 1e3:.3f} ms "
          f"= {sum(map(len, raws)) / wall / 1e9:.4f} GB/s; match stage per "
          f"window size (windows, sharded call ms, download ms) "
          f"{[(d['N'], d['windows'], round(d['sharded_ms'], 3), round(d['download_ms'], 3)) for d in dm]}"
          f"; stage split ms { {k: round(v * 1e3, 3) for k, v in stats.items() if isinstance(v, float)} }",
          flush=True)

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[mesh] multi-process demo not run: it needs two CUDA devices "
              f"(NCCL refuses two ranks on one card) and this machine has "
              f"{n_cards}", flush=True)
        return
    r = subprocess.run([sys.executable, "-m",
                        "lzfse_rust_tpu_torch.tools.demo_multihost",
                        "--device", "cuda", "--hosts", "2"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    rows = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    phase("mesh", r.returncode == 0 and len(rows) == 2
          and all(x["ok"] for x in rows),
          f"demo_multihost --device cuda --hosts 2 (NCCL): {rows or r.stderr[-2000:]}")


@contextlib.contextmanager
def env_var(name: str, value: str):
    """``os.environ[name]`` set to ``value`` inside the block, restored (or
    removed again) after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def api_run(pairs, digests, dec_wall: float, one_pass) -> None:
    """The public API on the serving batch, beside the card's batched
    engines from this run. Each batch entry point by both routes, the
    default (the card: one ``TorchDecoder`` / ``TorchEncoder`` call, whose
    kernels must launch) and ``device="cpu"`` (the host thread pool), one
    warm-up and one timed call each: ``decode_many`` == the raw inputs and
    the slice phase's ``TorchDecoder`` outputs; ``encode_many`` == the
    corpus containers and the encode phase's ``TorchEncoder`` outputs. On
    the largest input the ring engines, the writer and the reader round
    trip; ``probe`` on every container."""
    import io
    from lzfse_rust_tpu_torch import api
    from lzfse_rust_tpu_torch.ops import cuda_decode as KD
    from lzfse_rust_tpu_torch.ops import cuda_encode as KE
    from lzfse_rust_tpu_torch.utils import corpus as CP
    sources = [c for _, c in pairs]
    raw_bytes = sum(len(r) for r, _ in pairs)
    e_pairs = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in e_pairs]
    e_bytes = sum(map(len, raws))
    card_outs, _, e_card_wall = one_pass
    walls = {}
    for device, kern in (("cuda", KD), ("cpu", None)):
        api.decode_many(sources, device=device)   # warm-up
        reset_launches()
        t = time.perf_counter()
        outs = api.decode_many(sources, device=device)
        walls["decode", device] = time.perf_counter() - t
        launched = dict(kern.launches) if kern else {}
        got = [hashlib.sha256(o).digest() for o in outs]
        bad_raw = sum(g != hashlib.sha256(r).digest()
                      for g, (r, _) in zip(got, pairs))
        bad_card = sum(g != w for g, w in zip(got, digests))
        phase("api", bad_raw == 0 and bad_card == 0
              and all(n > 0 for n in launched.values()),
              f"decode_many(device={device!r}): {len(outs)} containers, SHA "
              f"mismatches against the raw inputs {bad_raw}, against "
              f"TorchDecoder('cuda') {bad_card}; launches {launched}")
    for device, kern in (("cuda", KE), ("cpu", None)):
        api.encode_many(raws, device=device)   # warm-up
        reset_launches()
        t = time.perf_counter()
        blobs = api.encode_many(raws, device=device)
        walls["encode", device] = time.perf_counter() - t
        launched = dict(kern.launches) if kern else {}
        bad_corpus = sum(b != c for b, (_, c) in zip(blobs, e_pairs))
        bad_card = sum(b != c for b, c in zip(blobs, card_outs))
        phase("api", bad_corpus == 0 and bad_card == 0
              and all(n > 0 for n in launched.values()),
              f"encode_many(device={device!r}): {len(blobs)} sources, "
              f"container mismatches against the corpus {bad_corpus}, "
              f"against TorchEncoder('cuda') {bad_card}; launches "
              f"{launched}")
    big, big_c = max(e_pairs, key=lambda p: len(p[0]))
    sink = io.BytesIO()
    n_raw, n_pay = api.LzfseRingEncoder().encode(io.BytesIO(big), sink)
    ring = sink.getvalue()
    back = io.BytesIO()
    n_pay2, n_raw2 = api.LzfseRingDecoder().decode(io.BytesIO(ring), back)
    w = api.LzfseRingEncoder().writer_bytes()
    for i in range(0, len(big), 100_003):
        w.write(big[i:i + 100_003])
    written = w.into_bytes()
    r = api.LzfseRingDecoder().reader_bytes(big_c)
    read = b"".join(iter(lambda: r.read(65_521), b""))
    probes = [api.probe(c) for c in sources]
    ok_probe = all(p == (len(c), len(raw))
                   for p, (raw, c) in zip(probes, pairs))
    phase("api", back.getvalue() == big and (n_raw, n_pay) == (
              len(big), len(ring)) and (n_pay2, n_raw2) == (len(ring),
                                                              len(big))
          and written == ring and read == big and ok_probe,
          f"largest input {len(big)} bytes: ring encode {n_pay} bytes and "
          f"back, writer == ring stream, reader == raw; probe == (payload, "
          f"raw) sizes on all {len(sources)} containers")
    def rate(n_bytes, wall):
        return f"{wall * 1e3:.3f} ms = {n_bytes / wall / 1e9:.4f} GB/s"

    print(f"[api] decode_many {raw_bytes} bytes: card "
          f"{rate(raw_bytes, walls['decode', 'cuda'])}, host "
          f"{rate(raw_bytes, walls['decode', 'cpu'])} (TorchDecoder('cuda'), "
          f"same run: {rate(raw_bytes, dec_wall)}); encode_many {e_bytes} "
          f"bytes: card {rate(e_bytes, walls['encode', 'cuda'])}, host "
          f"{rate(e_bytes, walls['encode', 'cpu'])} (TorchEncoder('cuda'), "
          f"same run: {rate(e_bytes, e_card_wall)}); {os.cpu_count()} host "
          f"cores", flush=True)


def cli_run(pairs) -> None:
    """``python3 -m lzfse_rust_tpu_torch.cli -encode`` and ``-decode`` as
    two processes, the first's output streamed into the second, on the
    largest raw input: SHA-exact, and the stream between them equals
    ``LzfseRingEncoder``'s."""
    import io
    import threading
    from lzfse_rust_tpu_torch import api
    big = max((r for r, _ in pairs), key=len)
    cmd = [sys.executable, "-m", "lzfse_rust_tpu_torch.cli"]
    t = time.perf_counter()
    enc_p = subprocess.Popen(cmd + ["-encode"], cwd=ROOT,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
    dec_p = subprocess.Popen(cmd + ["-decode"], cwd=ROOT,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
    stream = bytearray()

    def feed():
        enc_p.stdin.write(big)
        enc_p.stdin.close()

    def relay():
        for chunk in iter(lambda: enc_p.stdout.read(1 << 16), b""):
            stream.extend(chunk)
            dec_p.stdin.write(chunk)
        dec_p.stdin.close()

    threads = [threading.Thread(target=f, daemon=True) for f in (feed, relay)]
    for th in threads:
        th.start()
    out = dec_p.stdout.read()
    for th in threads:
        th.join(timeout=300)
    rcs = []
    for proc in (enc_p, dec_p):
        try:
            rcs.append(proc.wait(timeout=300))
        except subprocess.TimeoutExpired:
            proc.kill()
            rcs.append(proc.wait())
    errs = [proc.stderr.read().decode(errors="replace")[-500:]
            for proc in (enc_p, dec_p)]
    wall = time.perf_counter() - t
    sink = io.BytesIO()
    api.LzfseRingEncoder().encode(io.BytesIO(big), sink)
    phase("cli", rcs == [0, 0] and hashlib.sha256(out).digest()
          == hashlib.sha256(big).digest() and bytes(stream)
          == sink.getvalue(),
          f"-encode | -decode as two processes on {len(big)} bytes: exit "
          f"codes {rcs}, SHA-exact {out == big}, stream of {len(stream)} "
          f"bytes == LzfseRingEncoder's {bytes(stream) == sink.getvalue()}, "
          f"{wall:.2f} s with both processes' start {errs if any(rcs) else ''}")


CHUNK_COUNTS = (1, 2, 4)
CHUNK_ROUNDS = 3


def encode_chunks_run(enc, pairs, one_pass) -> None:
    """``TorchEncoder("cuda").encode_many`` on the serving batch's raw
    inputs with ``LZT_ENC_CHUNKS`` at 1, 2 and 4, in turns (1, 2, 4, 1, 2,
    4, ...), ``CHUNK_ROUNDS`` timed runs each after one warm-up: every
    container == the corpus's, ``pipeline_chunks`` == the count, each
    encode kernel launched once a chunk; walls and stage splits beside
    the encode phase's one-pass run."""
    from lzfse_rust_tpu_torch.ops import cuda_encode as K
    from lzfse_rust_tpu_torch.utils import corpus as CP
    pairs = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in pairs]
    raw_bytes = sum(map(len, raws))
    runs: dict = {n: [] for n in CHUNK_COUNTS}
    for n in CHUNK_COUNTS:
        with env_var("LZT_ENC_CHUNKS", str(n)):
            enc.encode_many(raws)
    for _ in range(CHUNK_ROUNDS):
        for n in CHUNK_COUNTS:
            with env_var("LZT_ENC_CHUNKS", str(n)):
                stats: dict = {}
                reset_launches()
                t = time.perf_counter()
                outs = enc.encode_many(raws, stats)
                wall = time.perf_counter() - t
            launches = dict(K.launches)
            bad = sum(o != c for o, (_, c) in zip(outs, pairs))
            phase("encode_chunks", bad == 0 and stats["pipeline_chunks"] == n
                  and all(v == n for v in launches.values()),
                  f"LZT_ENC_CHUNKS={n}: {len(outs)} sources, container "
                  f"mismatches {bad}, pipeline_chunks "
                  f"{stats['pipeline_chunks']}, launches {launches}")
            runs[n].append((wall, stats))
    _, o_split, o_wall = one_pass
    print(f"[encode_chunks] encode phase's one-pass run: {o_wall * 1e3:.3f} "
          f"ms, stage split ms {o_split}", flush=True)
    for n in CHUNK_COUNTS:
        walls = sorted(w for w, _ in runs[n])
        wall, stats = min(runs[n], key=lambda x: x[0])
        split = {k: round(v * 1e3, 3) for k, v in stats.items()
                 if isinstance(v, float)}
        dev = {k: round(v, 3) for k, v in stats["detail_device"].items()}
        print(f"[encode_chunks] LZT_ENC_CHUNKS={n}: walls ms "
              f"{[round(w * 1e3, 3) for w in walls]}, smallest "
              f"{walls[0] * 1e3:.3f} ms = {raw_bytes / walls[0] / 1e9:.4f} "
              f"GB/s; its stage split ms {split}; device events ms (summed "
              f"over chunks) {dev}", flush=True)


def argsort_cut(pairs) -> tuple[list, dict]:
    """For each window size the device frontend makes of ``pairs``' raw
    inputs, the smallest source with a window of that size: (those pairs,
    {N: source index})."""
    from lzfse_rust_tpu_torch import TorchEncoder
    raws = [r for r, _ in pairs]
    pick: dict = {}
    for i, _, _, _, N in TorchEncoder.windows(raws):
        if N not in pick or len(raws[i]) < len(raws[pick[N]]):
            pick[N] = i
    return [pairs[i] for i in sorted(set(pick.values()))], pick


def encode_argsort_run(pairs) -> None:
    """``TorchEncoder("cuda", frontend="device")`` with ``LZT_DEV_GROUPED=0``
    (the argsort branch: ``find_matches_compact`` as torch ops on the card)
    on a cut of the serving batch: for each window size the device
    frontend makes of the batch, the smallest source with a window of that
    size. Every container == the corpus's; both encode kernels launched."""
    import torch
    from lzfse_rust_tpu_torch import TorchEncoder
    from lzfse_rust_tpu_torch.models import encoder as ME
    from lzfse_rust_tpu_torch.ops import cuda_encode as K
    from lzfse_rust_tpu_torch.ops import match_find as MF
    from lzfse_rust_tpu_torch.utils import corpus as CP
    pairs = [(r, c) for r, c in pairs if c != CP.EMPTY]
    raws = [r for r, _ in pairs]
    wins = TorchEncoder.windows(raws)
    sub, pick = argsort_cut(pairs)
    cut = sorted(set(pick.values()))
    enc = TorchEncoder("cuda", frontend="device")
    with env_var("LZT_DEV_GROUPED", "0"):
        torch.cuda.reset_peak_memory_stats()
        stats: dict = {}
        reset_launches()
        t = time.perf_counter()
        outs = enc.encode_many([r for r, _ in sub], stats)
        wall = time.perf_counter() - t
    launches = dict(K.launches)
    bad = sum(o != c for o, (_, c) in zip(outs, sub))
    sizes = sorted(d["N"] for d in stats["detail_match"])
    phase("encode_argsort", bad == 0 and sizes == sorted(pick)
          and all(v == 1 for v in launches.values()),
          f"LZT_DEV_GROUPED=0 on a cut of the batch: {len(sub)} of "
          f"{len(pairs)} sources ({sum(len(r) for r, _ in sub)} of "
          f"{sum(map(len, raws))} raw bytes), the smallest with a window of "
          f"each size {sorted(pick)} (the host merge takes about a minute "
          f"on the whole batch); container mismatches {bad}, launches "
          f"{launches}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    # both match-finder paths on the same cut, in turns after the run
    # above: argsort, grouped, argsort, grouped
    cut_runs: dict = {"0": [(wall, stats["matchfind"])], "1": []}
    for flag in ("1", "0", "1"):
        with env_var("LZT_DEV_GROUPED", flag):
            st: dict = {}
            t = time.perf_counter()
            got = enc.encode_many([r for r, _ in sub], st)
            cut_runs[flag].append((time.perf_counter() - t, st["matchfind"]))
        phase("encode_argsort", all(o == c for o, (_, c) in zip(got, sub)),
              f"LZT_DEV_GROUPED={flag} on the same cut: every container == "
              f"the corpus's")
    for flag, name in (("0", "argsort"), ("1", "grouped")):
        print(f"[encode_argsort] LZT_DEV_GROUPED={flag} ({name}) on the cut: "
              f"walls ms {[round(w * 1e3, 3) for w, _ in cut_runs[flag]]}, "
              f"matchfind stage ms "
              f"{[round(m * 1e3, 3) for _, m in cut_runs[flag]]}", flush=True)
    det = stats["detail_match"]
    # A3's bound: its inputs read once, its full outputs written once, and
    # the grouped finder's least work (per slot the arbitration, per set
    # candidate the 8-byte words compared up to the first difference)
    n_bytes = n_ops = 0
    for N, idxs in sorted({N: [w for w in wins if w[0] in cut and w[4] == N]
                           for N in pick}.items()):
        pads = torch.zeros((len(idxs), N), dtype=torch.uint8)
        for r, (i, base, ctx, n, _) in enumerate(idxs):
            pads[r, :n] = torch.frombuffer(bytearray(raws[i][base:base + n]),
                                           dtype=torch.uint8)
        meta = torch.tensor([[n, ctx, ctx + ME.WINDOW_STRIDE]
                             for _, _, ctx, n, _ in idxs],
                            dtype=torch.int32).cuda()
        args = (pads.cuda(), meta[:, 0].contiguous(),
                meta[:, 1].contiguous(), meta[:, 2].contiguous())
        outs = MF.find_matches_compact(*args, False)
        cands, lcps = outs[4], outs[5]
        words = ((lcps.clamp(0, 63) >> 3) + 1)[cands >= 0]
        n_bytes += _nbytes(*args, *outs)
        n_ops += (MATCH_OPS_PER_SLOT * args[0].numel()
                  + MATCH_OPS_PER_WORD * int(words.sum()))
        del outs, cands, lcps, words
    b_ms, by = bound(n_bytes, n_ops)
    print(f"[bounds] A3 find_matches_compact (torch ops) on the cut's "
          f"{sum(d['windows'] for d in det)} windows: "
          f"{sum(d['kernel_ms'] for d in det):.4f} ms (CUDA events in "
          f"encode_many, the counts' read included), bound {b_ms:.6f} ms "
          f"({n_bytes} bytes, {n_ops} ops: {by})", flush=True)
    print(f"[encode_argsort] {wall * 1e3:.3f} ms; stage split ms "
          f"{ {k: round(v * 1e3, 3) for k, v in stats.items() if isinstance(v, float)} }"
          f"; per window size (N, windows, upload / match finding / download "
          f"ms, bytes down) "
          f"{[(d['N'], d['windows'], round(d['upload_ms'], 3), round(d['kernel_ms'], 3), round(d['download_ms'], 3), d['download_bytes']) for d in det]}"
          f"; peak device memory {peak_mib:.1f} MiB", flush=True)


def main() -> int:
    if not (ROOT / "lzfse_rust_tpu_torch").is_dir():
        print("chip_smoke: the package lzfse_rust_tpu_torch is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        kind = card()
        build()
        probe_rows = probes(SEED)
        pairs, _ = corpus(SEED)
        import torch
        from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
        dec = TorchDecoder("cuda")
        enc = TorchEncoder("cuda")
        enc_dev = TorchEncoder("cuda", frontend="device")
        rows = kernels(dec, enc, pairs) + [match_kernel(enc_dev, pairs),
                                           rebuild_kernel(dec, pairs)]
        launches, default, digests = slice_run(dec, pairs)
        launches.update(rebuild_run(pairs, default))
        tables_bound(pairs)
        enc_launches, native_gbps, one_pass = encode_run(enc, pairs)
        launches.update(enc_launches)
        dev_launches, *device_run = encode_device_run(enc_dev, pairs,
                                                      native_gbps)
        launches.update(dev_launches)
        encode_host_run(pairs, device_run)
        mesh_run(pairs, default)
        api_run(pairs, digests, default[2], one_pass)
        cli_run(pairs)
        encode_chunks_run(enc, pairs, one_pass)
        encode_argsort_run(pairs)
        for r in rows:
            r["launches"] = launches[r["name"]]
        rows += probe_rows
        phase("launches", all(r["launches"] > 0 for r in rows),
              f"{ {r['name']: r['launches'] for r in rows} }")
    except PhaseError as exc:
        print(f"chip_smoke: failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
