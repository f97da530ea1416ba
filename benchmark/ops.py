"""The two entries a mix can drive, and how their answers are judged.

A mix's ``op`` names one of ``OPS``. Each op makes the batch a client sends
from the raw inputs, builds one engine of the program per client (the
mix's ``engine`` keyword arguments passed through), calls it, checks every
call cheaply while the window runs, and judges the calls it kept against
the plain reference once the window has closed. Every check counts
faults; the run is correct when each count is at most its limit, 0.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from .corpus import seed_key
from .reference import check as CK

SPOT_CONTAINERS = 8       # containers spot-checked in every decode call
SPOT_BYTES = 64 << 10     # bytes compared in each
REF_BLOCKS = 6            # blocks the plain reference decodes, by raw size
# encode: containers of which the plain reference decodes one block each,
# and sources it encodes over a prefix, both drawn uniformly
UNIFORM_BLOCKS = 24
PREFIX_SOURCES = 6
PREFIX_BYTES = 64 << 10   # the prefix it starts from (doubled as needed)


def _pool_map(fn, items) -> list:
    with cf.ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as ex:
        return list(ex.map(fn, items))


class DecodeOp:
    """``TorchDecoder.decode_many`` on the configuration's containers,
    which set-up encodes once from the raw inputs with the program's
    native encoder; the plain reference judges them by decoding blocks."""

    def __init__(self, raws: list[bytes], seed: int, mix: dict):
        self.raws = raws
        self.seed = seed_key(seed)
        self.mix = mix
        self.nbytes = sum(map(len, raws))
        self.batch: list[bytes] | None = None

    def prepare(self) -> None:
        from lzfse_rust_tpu_torch.runtime.build import native_runtime
        enc = native_runtime().encode_bytes
        self.batch = _pool_map(enc, self.raws)

    def engine(self, device: str):
        from lzfse_rust_tpu_torch import TorchDecoder
        return TorchDecoder(device, **self.mix.get("engine", {}))

    def call(self, engine, stats: dict) -> list:
        return engine.decode_many(self.batch, stats)

    def quick(self, outs, stats: dict, key: tuple) -> dict:
        """Every output's length, ``SPOT_CONTAINERS`` seeded slices of
        ``SPOT_BYTES`` against the raw inputs, and the program's count of
        spec-layer fallbacks."""
        raws = self.raws
        bad_len = (len(raws) - len(outs) if len(outs) < len(raws) else 0) + \
            sum(len(o) != len(r) for o, r in zip(outs, raws))
        rng = np.random.default_rng([self.seed, key[0], key[1] + 1])
        spots = 0
        for ci in rng.choice(len(raws), min(SPOT_CONTAINERS, len(raws)),
                             replace=False):
            ci = int(ci)
            n = len(raws[ci])
            a = int(rng.integers(0, max(n - SPOT_BYTES, 0) + 1))
            out = outs[ci] if ci < len(outs) else b""
            spots += out[a:a + SPOT_BYTES] != raws[ci][a:a + SPOT_BYTES]
        return {"bad_lengths": int(bad_len), "bad_spots": int(spots),
                "fallbacks": int(stats.get("fallbacks", 0))}

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """Each kept call's outputs against the raw inputs, byte for byte;
        then ``REF_BLOCKS`` blocks of the containers decoded by the plain
        reference, which shows the containers stand for those bytes."""
        bad = 0
        for outs in kept:
            bad += sum(o != r for o, r in zip(outs, self.raws))
            bad += max(len(self.raws) - len(outs), 0)
        ref = CK.check_blocks(self.batch, self.raws, rng, REF_BLOCKS)
        return {"bad_outputs": int(bad), "ref_bad_blocks": ref["bad"]}


class EncodeOp:
    """``TorchEncoder.encode_many`` on the raw inputs. Every call's
    containers must equal the warm-up call's, which the plain reference
    judges: each container's structure, blocks decoded against the raw
    bytes, and sources encoded by the spec encoder over a prefix."""

    def __init__(self, raws: list[bytes], seed: int, mix: dict):
        self.raws = raws
        self.seed = seed_key(seed)
        self.mix = mix
        self.nbytes = sum(map(len, raws))
        self.batch = raws
        self.first: list | None = None

    def prepare(self) -> None:
        pass

    def engine(self, device: str):
        from lzfse_rust_tpu_torch import TorchEncoder
        return TorchEncoder(device, **self.mix.get("engine", {}))

    def call(self, engine, stats: dict) -> list:
        return engine.encode_many(self.batch, stats)

    def warmed(self, outs) -> None:
        """The warm-up call's containers: what every later call must give."""
        self.first = list(outs)

    def quick(self, outs, stats: dict, key: tuple) -> dict:
        first = self.first
        n = len(self.raws)
        bad_len = max(n - len(outs), 0) + sum(
            not isinstance(o, bytes) or not o for o in outs)
        unstable = sum(o != f for o, f in zip(outs, first or outs))
        return {"bad_lengths": int(bad_len), "unstable_outputs": int(unstable)}

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """The warm-up call's containers against the plain reference:
        every container's block headers and raw sizes; ``REF_BLOCKS``
        blocks drawn by raw size and one block of each of
        ``UNIFORM_BLOCKS`` containers drawn uniformly, decoded against the
        raw bytes; and ``PREFIX_SOURCES`` sources drawn uniformly, encoded
        by the spec encoder over their first ``PREFIX_BYTES`` bytes (whole
        when no longer) and compared block for block."""
        first = self.first
        bad_struct = max(len(self.raws) - len(first), 0)
        for c, r in zip(first, self.raws):
            try:
                blocks = CK.walk(c)
                bad_struct += sum(b.n_raw for b in blocks) != len(r)
            except Exception:   # any parse failure is a bad container
                bad_struct += 1
        bad_blocks = CK.check_blocks(first, self.raws, rng, REF_BLOCKS)["bad"]
        bad_blocks += CK.check_block_each(first, self.raws, rng,
                                          UNIFORM_BLOCKS)["bad"]
        bad_prefix = 0
        for i in CK.pick(rng, len(self.raws), PREFIX_SOURCES):
            got = first[i] if i < len(first) else b""
            bad_prefix += CK.check_prefix(got, self.raws[i],
                                          PREFIX_BYTES)["bad"]
        return {"bad_structure": int(bad_struct),
                "bad_blocks": int(bad_blocks),
                "bad_prefix_blocks": int(bad_prefix)}


OPS = {"decode": DecodeOp, "encode": EncodeOp}
