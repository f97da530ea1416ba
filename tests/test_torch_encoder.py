"""TorchEncoder against the JAX reference encoder and the native encoder.

On the CPU the encoder runs its kernels' plain versions. One mixed batch
(seeded sources of 40-60 KB, a period-13 source whose blocks have a
period-split alternative, inputs at and below ``VN_CUTOFF`` and the empty
input) must encode to the same containers as
``TpuEncoder._encode_many_staged`` with its Pallas kernels in interpret
mode and as ``native.encode_bytes``; ``encode_bytes`` must equal
``TpuEncoder.encode_bytes`` on its device path. More seeded batches are
held against the native encoder, and every container decodes back through
``TorchDecoder``. With ``LZT_ENC_CHUNKS`` at 2 and 3 the chunked pipeline
must give the same containers as the JAX encoder's chunked pipeline, call
each kernel's plain version once a chunk, and survive a pool overflow in
its second chunk.
"""

import numpy as np
import pytest

from jax.experimental import pallas as pl

from lzfse_rust_tpu.base import constants as C
from lzfse_rust_tpu.models.encoder import TpuEncoder
from lzfse_rust_tpu.spec import fse as F
from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
from lzfse_rust_tpu_torch.models import encoder as M
from lzfse_rust_tpu_torch.ops import cuda_encode as K
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.utils import corpus
from torch_kit import chunk_spans, overflow_in_second_chunk

STAGES = {"small", "frontend", "emit_prep", "emit_kernels", "pack"}


def _period13(n: int, seed: int) -> bytes:
    pat = np.random.default_rng(seed).integers(0, 256, 13, np.uint8)
    return (pat.tobytes() * (n // 13 + 1))[:n]


@pytest.fixture(scope="module")
def nat():
    return native_runtime()


@pytest.fixture(scope="module")
def enc():
    return TorchEncoder("cpu")


@pytest.fixture(scope="module")
def mixed():
    raws = [r for r, _ in corpus.small_batch(seed=17, n_fse=3, lo=40_000,
                                             hi=60_000)]
    return raws + [_period13(45_000, 7), b"", b"x" * C.VN_CUTOFF,
                   bytes(range(256)) * 16 + b"!"]


@pytest.fixture(scope="module")
def bigs(mixed):
    """The batch's sources above VN_CUTOFF (they reach the kernels)."""
    return [s for s in mixed if len(s) > C.VN_CUTOFF]


@pytest.fixture
def interpret(monkeypatch):
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))


def test_encode_many_equals_tpu_encoder_interpret(mixed, enc, nat,
                                                  interpret):
    assert len(mixed[-1]) == C.VN_CUTOFF + 1
    big = [i for i, s in enumerate(mixed) if len(s) > C.VN_CUTOFF]
    small = [i for i, s in enumerate(mixed) if len(s) <= C.VN_CUTOFF]
    assert len(big) >= 5 and len(small) >= 4
    ref = TpuEncoder(device_emission=True, frontend="native")
    want = ref._encode_many_staged(mixed, big, [None] * len(mixed))
    assert ref.last_emission == "device"
    stats: dict = {}
    got = enc.encode_many(mixed, stats)
    assert enc.last_emission == "device"
    for i in big:
        assert got[i] == want[i], i
    assert got == [nat.encode_bytes(s) for s in mixed]
    assert STAGES <= set(stats) and "detail_device" not in stats
    nb = stats["download_bytes"] // (4 * (4 * M.N_COLS + 7))
    assert stats["download_bytes"] == nb * 4 * (4 * M.N_COLS + 7)
    assert stats["upload_bytes"] == nb * (8 * C.N_WEIGHTS
                                          + 4 * (3 * M.N_COLS + 4))


def test_period_split_alternative_is_staged_and_chosen(enc, nat):
    """The period-13 source stages alternative slots, and its container
    is the native encoder's (which takes the smaller of the two)."""
    src = _period13(45_000, 7)
    pool, nb, out_lists, nb_of, _ = enc._frontends([src], [0])
    alts = pool.a["meta"][:nb, 2]
    assert (alts >= 0).any() and nb > nb_of[0]
    assert enc.encode_many([src]) == [nat.encode_bytes(src)]


def test_encode_many_keeps_the_block_on_a_tie(enc, nat, monkeypatch):
    """A block and its alternative of equal length: the block as it is
    wins. The alternatives' bodies are overwritten with a marker of the
    block's length after packing; no marker may reach the output."""
    real = nat.pack_stage
    cap = nat.PACK_SLOT_CAP
    ties = []

    def pack_stage(*args):
        real(*args)
        meta, nb, arena, lens = args[8], args[11], args[12], args[13]
        for s in range(nb):
            alt = int(meta[s, 2])
            if alt >= 0:
                lens[alt] = lens[s]
                arena[alt * cap:alt * cap + lens[s]] = 0xAA
                ties.append(s)

    monkeypatch.setattr(nat, "pack_stage", pack_stage)
    out = enc.encode_many([_period13(45_000, 7)])[0]
    assert ties and b"\xaa" * 32 not in out


def test_encode_bytes_keeps_the_block_on_a_tie(enc, monkeypatch):
    blocks = TpuEncoder._parse_blocks(
        native_runtime().frontend_blocks(_period13(45_000, 7)))
    monkeypatch.setattr(enc, "_emit_blocks",
                        lambda flat, *timing: [b"%d" % (i % 10) * 7
                                               for i in range(len(flat))])
    assert len(blocks) < 10
    assert any(F.period_split_rows(rows) is not None for _, rows, _ in blocks)
    got = enc._emit_best(blocks)
    assert got == [b"%d" % i * 7 for i in range(len(blocks))]


def test_encode_bytes_equals_tpu_encoder_interpret(bigs, enc, nat,
                                                   interpret):
    ref = TpuEncoder(device_emission=True, frontend="native")
    for src in (bigs[0], _period13(45_000, 7), b"tiny"):
        want = ref.encode_bytes(src)
        if len(src) > C.VN_CUTOFF:
            assert ref.last_emission == "device"
        got = enc.encode_bytes(src)
        assert got == want
        assert got == nat.encode_bytes(src)


def test_round_trip_through_torch_decoder(mixed, enc):
    blobs = enc.encode_many(mixed)
    assert TorchDecoder("cpu").decode_many(blobs) == mixed


@pytest.mark.parametrize("seed", range(4))
def test_seeded_batches_equal_native(seed, enc, nat):
    rng = np.random.default_rng(300 + seed)
    raws = [r for r, _ in corpus.small_batch(seed=300 + seed, n_fse=3,
                                             lo=5_000, hi=50_000)]
    raws.append(corpus.make_raw(("urls", "random")[seed % 2],
                                int(rng.integers(41_000, 90_000)), rng))
    got = enc.encode_many(raws)
    assert got == [nat.encode_bytes(r) for r in raws]
    # a second call reuses the staging pool; nothing may bleed across
    assert enc.encode_many(raws[::-1]) == got[::-1]


@pytest.mark.parametrize("wrapper", ["encode_literals", "encode_lmds"])
def test_kernel_failure_propagates(wrapper, bigs, enc, nat, monkeypatch):
    """A failing kernel raises out of both entry points; nothing falls
    back to a host encoder, and the encoder works again afterwards."""
    def boom(**kw):
        raise RuntimeError(f"{wrapper} failed")

    monkeypatch.setattr(K, wrapper, boom)
    with pytest.raises(RuntimeError, match=f"{wrapper} failed"):
        enc.encode_many(bigs[:2])
    with pytest.raises(RuntimeError, match=f"{wrapper} failed"):
        enc.encode_bytes(bigs[0])
    monkeypatch.undo()
    assert enc.encode_many(bigs[:2]) == [nat.encode_bytes(s)
                                         for s in bigs[:2]]


def test_pool_overflow_is_retried_with_a_bigger_pool(bigs, nat,
                                                     monkeypatch):
    """A staging pool too small for the batch makes frontend_stage fail;
    the encoder doubles the pool and runs the frontends again."""
    asked = []
    real = TorchEncoder._staging

    def staging(self, slots):
        asked.append(slots)
        return real(self, slots)

    monkeypatch.setattr(M, "_round_up", lambda n, step: 2 if not asked[1:]
                        else n)
    monkeypatch.setattr(TorchEncoder, "_staging", staging)
    enc = TorchEncoder("cpu")
    got = enc.encode_many(bigs[:3])
    assert len(asked) == 2 and asked[1] == 2 * asked[0]
    assert got == [nat.encode_bytes(s) for s in bigs[:3]]


def test_a_source_that_stages_no_block_raises(bigs, nat, monkeypatch):
    monkeypatch.setattr(nat, "frontend_stage", lambda *a: 0)
    with pytest.raises(RuntimeError, match="closed no block"):
        TorchEncoder("cpu").encode_many(bigs[:1])


def test_kernel_args_match_encoder_layout(mixed, enc):
    lit, lmd = enc.kernel_args(mixed)
    nb = lit["e_u"].shape[0]
    assert lit["words"].shape == (nb, M.N_COLS)
    assert lmd["lm"].shape == lmd["d"].shape == (nb, M.N_COLS)
    assert (lit["num"] % 4 == 0).all()
    for args, kind in ((lit, "literals"), (lmd, "lmds")):
        steps = K.steps_of(kind, args["num"], M.N_COLS)[args["order"].long()]
        assert sorted(args["order"].tolist()) == list(range(nb))
        assert (steps[:-1] >= steps[1:]).all()   # longest first


@pytest.fixture
def chunk_calls(monkeypatch):
    """Calls of each encode wrapper (their plain versions on the CPU)."""
    calls = {"encode_literals": 0, "encode_lmds": 0}
    for name in calls:
        real = getattr(K, name)

        def spy(real=real, name=name, **kw):
            calls[name] += 1
            return real(**kw)

        monkeypatch.setattr(K, name, spy)
    return calls


@pytest.mark.parametrize("n_chunks", [2, 3])
def test_chunked_encode_equals_tpu_encoder_interpret(n_chunks, mixed, enc,
                                                     nat, chunk_calls,
                                                     interpret, monkeypatch):
    """``LZT_ENC_CHUNKS`` at 2 and 3, read by both encoders: the same
    containers as ``TpuEncoder._encode_many_staged`` (its chunked
    pipeline, Pallas kernels in interpret mode) and ``native.encode_bytes``;
    each wrapper called once a chunk."""
    monkeypatch.setenv("LZT_ENC_CHUNKS", str(n_chunks))
    big = [i for i, s in enumerate(mixed) if len(s) > C.VN_CUTOFF]
    ref = TpuEncoder(device_emission=True, frontend="native")
    ref_stats: dict = {}
    want = ref._encode_many_staged(mixed, big, [None] * len(mixed),
                                   ref_stats)
    assert ref_stats["pipeline_chunks"] == n_chunks
    stats: dict = {}
    got = enc.encode_many(mixed, stats)
    for i in big:
        assert got[i] == want[i], i
    assert got == [nat.encode_bytes(s) for s in mixed]
    assert stats["pipeline_chunks"] == n_chunks
    assert chunk_calls == {"encode_literals": n_chunks,
                           "encode_lmds": n_chunks}
    assert STAGES | {"emit_dispatch"} <= set(stats)
    nb = stats["download_bytes"] // (4 * (4 * M.N_COLS + 7))
    assert stats["download_bytes"] == nb * 4 * (4 * M.N_COLS + 7)
    assert stats["upload_bytes"] == nb * (8 * C.N_WEIGHTS
                                          + 4 * (3 * M.N_COLS + 4))


@pytest.mark.parametrize("setting,chunks", [("1", 1), ("0", 1), ("-3", 1),
                                            ("5", 5), ("40", 5)])
def test_chunk_count_is_clamped(setting, chunks, bigs, enc, nat,
                                chunk_calls, monkeypatch):
    """Clamped to [1, sources above VN_CUTOFF], as the JAX encoder does;
    every count goes through the same stages."""
    assert len(bigs) == 5
    monkeypatch.setenv("LZT_ENC_CHUNKS", setting)
    stats: dict = {}
    assert enc.encode_many(bigs, stats) == [nat.encode_bytes(s) for s in bigs]
    assert stats["pipeline_chunks"] == chunks
    assert chunk_calls["encode_literals"] == chunks
    assert STAGES | {"emit_dispatch"} <= set(stats)


def test_chunks_deal_the_biggest_sources_round_robin(bigs, nat, monkeypatch):
    """Chunk c holds the sources of rank c, c + n, ... by size, each
    chunk's slots contiguous and in chunk order."""
    monkeypatch.setenv("LZT_ENC_CHUNKS", "2")
    seen = []
    real = nat.frontend_stage

    def stage(src, bufs, counter, out_idx):
        seen.append(len(src))
        return real(src, bufs, counter, out_idx)

    monkeypatch.setattr(nat, "frontend_stage", stage)
    spans = chunk_spans("cpu", bigs, monkeypatch)
    ranked = sorted(map(len, bigs), reverse=True)
    assert sorted(seen[:3], reverse=True) == ranked[0::2]
    assert sorted(seen[3:], reverse=True) == ranked[1::2]
    assert spans[0][0] == 0 and spans[0][1] == spans[1][0] < spans[1][1]


def test_chunked_pool_overflow_in_the_second_chunk(monkeypatch):
    """The second chunk overflows the pool: the encoder doubles it and
    stages every chunk again; the containers do not change."""
    raws = [r for r, _ in corpus.small_batch(seed=24, n_fse=6, lo=40_000,
                                             hi=120_000)]
    raws.append(_period13(45_000, 24))
    monkeypatch.setenv("LZT_ENC_CHUNKS", "2")
    got, asked, spans, first = overflow_in_second_chunk("cpu", raws,
                                                        monkeypatch)
    assert asked == [first[0][1] + 1, 2 * (first[0][1] + 1)]
    assert spans == [first[0]] + first
    assert got == [native_runtime().encode_bytes(r) for r in raws]


def test_an_alternative_outside_its_chunk_raises(bigs, nat, monkeypatch):
    """A period-split alternative slot is staged by its block's own
    frontend call; one pointing outside its chunk is refused."""
    monkeypatch.setenv("LZT_ENC_CHUNKS", "2")
    real = nat.frontend_stage

    def stage(src, bufs, counter, out_idx):
        n = real(src, bufs, counter, out_idx)
        bufs[6][int(out_idx[0]), 2] = int(counter[0]) + 7
        return n

    monkeypatch.setattr(nat, "frontend_stage", stage)
    with pytest.raises(RuntimeError, match="outside its chunk"):
        TorchEncoder("cpu").encode_many(bigs)
