"""Tests of the port that need an NVIDIA GPU (marked ``cuda``; they skip
without one). Like the port on the card, they import no JAX.

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
from lzfse_rust_tpu_torch.models import encoder as ME
from lzfse_rust_tpu_torch.ops import cuda_decode as K
from lzfse_rust_tpu_torch.ops import cuda_encode as KE
from lzfse_rust_tpu_torch.ops import cuda_probes as P
from lzfse_rust_tpu_torch.ops import cuda_rebuild as CR
from lzfse_rust_tpu_torch.ops import match_find as MF
from lzfse_rust_tpu_torch.ops import table_build as TB
from lzfse_rust_tpu_torch.ops.fse_encode import build_encode_tables
from lzfse_rust_tpu_torch.parallel.dryrun import dryrun_multichip
from lzfse_rust_tpu_torch.parallel.mesh import (make_mesh,
                                                sharded_grouped_match,
                                                sharded_pallas_entropy_decode,
                                                sharded_rebuild)
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.tools import microbench_step as PS
from lzfse_rust_tpu_torch.utils import corpus
from torch_kit import (REBUILD_CASES, blocks_of, encode_blocks, encode_rows,
                       grouped_inputs, overflow_in_second_chunk, port_args,
                       rebuild_case, window_rows, words)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    """On a card: each kernel equals its plain version bit for bit."""
    blocks = blocks_of(corpus.small_batch(seed=12, n_fse=8))
    for kind, fn, ref in (("literals", K.decode_literals,
                           K.decode_literals_ref),
                          ("lmds", K.decode_lmds, K.decode_lmds_ref)):
        args, _ = port_args(blocks, kind)
        args = {k: v.cuda() if torch.is_tensor(v) else v
                for k, v in args.items()}
        before = K.launches[fn.__name__]
        got = fn(**args)
        torch.cuda.synchronize()
        assert K.launches[fn.__name__] == before + 1
        for g, w in zip(got, ref(**args)):
            assert torch.equal(g, w)


def _decode_cases(kind, args):
    """Each decode kernel against its plain version on the card."""
    fn, ref = ((K.decode_literals, K.decode_literals_ref) if kind == "literals"
               else (K.decode_lmds, K.decode_lmds_ref))
    args = {k: v.cuda() if torch.is_tensor(v) else v for k, v in args.items()}
    before = K.launches[fn.__name__]
    got = fn(**args)
    torch.cuda.synchronize()
    assert K.launches[fn.__name__] == before + 1
    for g, w in zip(got, ref(**args)):
        assert torch.equal(g, w), kind


def _synthetic(kind, rng, lens, pos, states, num, tot=None, tables=None):
    """Decode kernel arguments for len(lens) streams of random payload
    words (each stream's words at its own offset, a gap between them)."""
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int64)  # noqa: E731
                                     .astype(np.int32))
    B = len(lens)
    off = np.concatenate(([3], 3 + np.cumsum(np.asarray(lens) + 5)[:-1]))
    words = rng.integers(-2**31, 2**31, int(off[-1] + lens[-1] + 7))
    counts = K.literal_counts(num) if kind == "literals" else np.asarray(num)
    out_off, n_out = K.out_offsets(counts)
    if tables is None:
        tables = rng.integers(-2**31, 2**31, (B, 384))
    args = dict(tables=i32(tables), words=i32(words), word_off=i32(off),
                word_len=i32(lens), states=i32(states), pos=i32(pos),
                num=i32(num), out_off=i32(out_off), n_out=n_out)
    if kind == "literals":
        args["tot"] = i32(tot)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["literals", "lmds"])
def test_cuda_decode_more_streams_than_a_block(kind):
    """More streams than one CUDA block holds, and a count that is not a
    multiple of it: real blocks, repeated."""
    blocks = blocks_of(corpus.small_batch(seed=13, n_fse=6, lo=3_000,
                                          hi=9_000))
    per_block = K.streams_per_block()
    want = 3 * per_block + 5
    args, _ = port_args((blocks * (want // len(blocks) + 1))[:want], kind)
    assert args["tables"].shape[0] % per_block != 0
    _decode_cases(kind, args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["literals", "lmds"])
def test_cuda_decode_edge_streams(kind):
    """Garbage tables (any k, delta, slow entries), streams of 0 steps and
    of 0 words, reads below bit 0, negative and far positions; literal
    states latched, at tot, above 1,023 and negative."""
    rng = np.random.default_rng(17)
    B = max(2 * K.streams_per_block(), 16) + 3   # 12 hand-set streams
    lens = rng.integers(0, 40, B)
    lens[:3] = 0
    num = rng.integers(0, 200, B)
    num[3:6] = 0
    pos = lens * 32 - rng.integers(0, 64, B)
    pos[6:9] = (5, 40, -3)
    pos[9] = 2**31 - 1
    lanes = 4 if kind == "literals" else 3
    states = rng.integers(-2**31, 2**31, (B, lanes))
    states[::2] = rng.integers(0, 1024, (len(states[::2]), lanes))
    tot = rng.integers(0, 1100, B)
    tot[:4] = (0, 1024, 1100, 700)
    if kind == "literals":
        states[10] = (tot[10], 1023, 1024, -1)
        states[11] = (-2**31, 2**31 - 1, 5000, tot[11] + 1)
    _decode_cases(kind, _synthetic(kind, rng, lens, pos, states, num, tot))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["literals", "lmds"])
def test_cuda_decode_payload_ends_at_a_refill_chunk(kind):
    """Payloads that end exactly at a refill chunk (multiples of 16 and 32
    words) and one word past it, read from their top bit all the way down and below bit 0,
    through the real tables of corpus blocks (states stay in range)."""
    rng = np.random.default_rng(19)
    blocks = blocks_of(corpus.small_batch(seed=23, n_fse=4, lo=3_000,
                                          hi=9_000))
    lens = np.array([16, 17, 32, 33, 48, 49, 64, 65, 128, 129, 1, 15])
    B = len(lens)
    real, _ = port_args((blocks * B)[:B], kind)
    tables = real["tables"].numpy()
    states = real["states"].numpy()
    # enough steps to read every word, then keep going below bit 0
    num = lens * 32 // (4 if kind == "literals" else 3) * 4 + 64
    _decode_cases(kind, _synthetic(
        kind, rng, lens, lens * 32, states, num,
        real["tot"].numpy() if kind == "literals" else None, tables))


@pytest.mark.cuda
def test_cuda_decoder_end_to_end():
    """On a card: the decoder runs both kernels and returns the raw bytes."""
    mixed = corpus.small_batch(seed=21, n_fse=5, lo=3_000, hi=16_000)
    cuda = TorchDecoder("cuda")
    before = dict(K.launches)
    stats: dict = {}
    got = cuda.decode_many([c for _, c in mixed], stats)
    assert got == [r for r, _ in mixed]
    assert stats.get("fallbacks", 0) == 0
    assert all(K.launches[k] == before[k] + 1 for k in before)
    assert set(stats["detail_device"]) == {"upload_ms", "kernels_ms",
                                           "download_ms"}


@pytest.mark.cuda
def test_cuda_encode_kernels_equal_plain_versions():
    """On a card: each encode kernel equals its plain version bit for bit
    on the defined columns and the final states."""
    rng = np.random.default_rng(12)
    raws = [corpus.make_raw(k, int(rng.integers(20_000, 90_000)), rng)
            for k in ("text", "binary", "urls", "random")]
    st = encode_rows(encode_blocks(raws), 10112)
    cuda = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in st.items()}
    e_l, e_m, e_d, e_u = build_encode_tables(cuda["weights"])
    i32 = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    cases = (
        ("literals", KE.encode_literals, KE.encode_literals_ref,
         dict(e_u=e_u, words=cuda["words"], num=cuda["lit_num"],
              order=i32(KE.slot_order(
                  KE.steps_of("literals", st["lit_num"], 10112))))),
        ("lmds", KE.encode_lmds, KE.encode_lmds_ref,
         dict(e_l=e_l, e_m=e_m, e_d=e_d, lm=cuda["lm"], d=cuda["d"],
              num=cuda["lmd_num"], order=i32(KE.slot_order(st["lmd_num"])))))
    for kind, fn, ref, args in cases:
        before = KE.launches[fn.__name__]
        got = KE.defined_columns(kind, fn(**args), args["num"])
        torch.cuda.synchronize()
        assert KE.launches[fn.__name__] == before + 1
        want = KE.defined_columns(kind, ref(**args), args["num"])
        for g, w in zip(got, want):
            assert torch.equal(g, w), kind


def _encode_synthetic(kind, rng, num, n_cols, offset=0):
    """Encode kernel arguments (CUDA tensors) for len(num) slots: garbage E
    tables (any t_k and t_w, so n reaches 0 and 25, totals pass 64 and
    states wrap int32), except slot 0's all-zero table (n stays 0) and slot
    1's all-0x7FFF one (n clamps at 25), and rows of any int32 (negative
    and out-of-range lm and d). ``offset`` words before the rows shift
    them off 16-byte alignment."""
    B = len(num)
    i32 = np.iinfo(np.int32)

    def draw(*shape):
        return rng.integers(i32.min, i32.max + 1, shape, dtype=np.int64)

    def rows():
        flat = torch.from_numpy(draw(B * n_cols + offset).astype(np.int32))
        return flat.cuda()[offset:].view(B, n_cols)

    widths = {"e_u": 256} if kind == "literals" else {"e_l": 20, "e_m": 20,
                                                      "e_d": 64}
    args = {}
    for key, width in widths.items():
        tab = draw(B, width)
        tab[0] = 0
        tab[1 % B] = 0x7FFF | (rng.integers(0, 1 << 16) << 15)
        args[key] = torch.from_numpy(tab.astype(np.int32)).cuda()
    for key in (("words",) if kind == "literals" else ("lm", "d")):
        args[key] = rows()
    args["num"] = torch.from_numpy(np.asarray(num, np.int64)
                                   .astype(np.int32)).cuda()
    return args


def _encode_cases(kind, args, rng, totals=True):
    """Each encode kernel equals its plain version on the defined columns
    and the final states, under the longest-first order and two random
    permutations."""
    fn, ref = ((KE.encode_literals, KE.encode_literals_ref)
               if kind == "literals" else (KE.encode_lmds, KE.encode_lmds_ref))
    B, n_cols = args["num"].numel(), args["lm" if kind == "lmds"
                                          else "words"].shape[1]
    steps = KE.steps_of(kind, args["num"].cpu().numpy(), n_cols)
    orders = [KE.slot_order(steps), rng.permutation(B), rng.permutation(B)]
    base = {**args, "order": torch.from_numpy(orders[0]).cuda()}
    want = KE.defined_columns(kind, ref(**base), args["num"])
    if totals:   # the group total passes 64 somewhere
        total = want[1] >> (8 if kind == "literals" else 22)
        assert int(total.max()) >= 64
    for order in orders:
        call = {**args, "order": torch.from_numpy(
            np.asarray(order, np.int32)).cuda()}
        before = KE.launches[fn.__name__]
        got = KE.defined_columns(kind, fn(**call), args["num"])
        torch.cuda.synchronize()
        assert KE.launches[fn.__name__] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), kind


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["literals", "lmds"])
@pytest.mark.parametrize("extra,offset", [(7, 0), (8, 0), (8, 1)],
                         ids=["ragged", "aligned", "unaligned"])
def test_cuda_encode_edge_rows(kind, extra, offset):
    """Rows of 0 steps and num <= 0; step counts at a tile boundary and one
    either side; literal num not a multiple of 4 and above 4 n_cols (the
    clamp); n_cols not a multiple of 4, or rows off 16-byte alignment (the
    scalar copies and stores); a slot count that is not a multiple of
    kSlots."""
    rng = np.random.default_rng(41)
    T = KE.tile_steps()
    n_cols = 2 * T + extra   # two tile boundaries inside the row
    per = 4 if kind == "literals" else 1
    steps = [T - 1, T, T + 1, 2 * T - 1, 2 * T, 2 * T + 1, 1, 2, 3, 4, 5,
             n_cols - 1, n_cols]
    num = [0, -1, -2**31, 2**31 - 1, n_cols * per + 1]
    num += [s * per - (i % per) for i, s in enumerate(steps)]
    num += [4 * n_cols + 3, 4 * n_cols + 4, 4 * n_cols + 5] if per == 4 else []
    per_block = KE.slots_per_block()
    B = per_block * (len(num) // per_block + 3) + 1
    num += rng.integers(-3, n_cols * per + 9, B - len(num)).tolist()
    # slots 0 and 1 (fixed tables) run long
    num[0], num[1] = n_cols * per, 2 * T * per
    assert len(num) == B and (B % per_block != 0 or per_block == 1)
    _encode_cases(kind, _encode_synthetic(kind, rng, num, n_cols, offset), rng)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["literals", "lmds"])
def test_cuda_encode_one_slot(kind):
    """B = 1: one CUDA block holding one slot, the whole row."""
    rng = np.random.default_rng(43)
    n_cols = 4 * KE.tile_steps()
    num = [n_cols * (4 if kind == "literals" else 1)]
    _encode_cases(kind, _encode_synthetic(kind, rng, num, n_cols), rng,
                  totals=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["literals", "lmds"])
def test_cuda_encode_more_slots_than_a_wave(kind):
    """More CUDA blocks than the card holds at once (132 SMs, at most 8
    blocks each), short rows of random lengths."""
    rng = np.random.default_rng(47)
    n_cols = 33
    B = 132 * 8 * KE.slots_per_block() + 3
    per = 4 if kind == "literals" else 1
    num = rng.integers(-5, n_cols * per + 10, B)
    _encode_cases(kind, _encode_synthetic(kind, rng, num, n_cols), rng)


@pytest.mark.cuda
def test_cuda_encoder_end_to_end():
    """On a card: the encoder runs both kernels and writes the native
    encoder's containers."""
    raws = [r for r, _ in corpus.small_batch(seed=21, n_fse=5, lo=3_000,
                                             hi=60_000)]
    nat = native_runtime()
    want = [nat.encode_bytes(r) for r in raws]
    enc = TorchEncoder("cuda")
    before = dict(KE.launches)
    stats: dict = {}
    assert enc.encode_many(raws, stats) == want
    assert all(KE.launches[k] == before[k] + 1 for k in before)
    assert set(stats["detail_device"]) == {"upload_ms", "kernels_ms",
                                           "download_ms"}
    big = max(raws, key=len)
    assert enc.encode_bytes(big) == nat.encode_bytes(big)
    assert all(KE.launches[k] == before[k] + 2 for k in before)


def _match_cases(a: dict, vn: bool):
    """The grouped-match kernel (``match_rows``) against its plain version
    on the card, on numpy arguments ``a``; the plain version is never taken
    for CUDA tensors. Returns every slot's keys (from the plain version's
    first half) and the kernel's rows."""
    args = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in a.items()}
    before = MF.launches["match_grouped"]
    got = MF.match_rows(**args, vn=vn)
    torch.cuda.synchronize()
    assert MF.launches["match_grouped"] == before + 1
    for g, w in zip(got, MF.match_rows_ref(**args, vn=vn)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return MF.grouped_compact_ref(**args, vn=vn)[0], got


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True])
def test_cuda_match_grouped_one_window(vn):
    rng = np.random.default_rng(61)
    n = 4096 - 128
    rows = [(words(rng, 4096)[:n], n, 0, n - 3)]
    keys = _match_cases(grouped_inputs(rows, 4096, vn,
                                       native_runtime().match_group), vn)[0]
    assert (keys == 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True])
def test_cuda_match_grouped_edge_windows(vn):
    """Saturating runs, an all-zero row (every probed slot saturated), a
    match truncated at n_real, random bytes, n_real below 4, and lo/hi
    cutting the payload."""
    keys = _match_cases(grouped_inputs(window_rows(4096, 62 + vn), 4096, vn,
                                       native_runtime().match_group), vn)[0]
    assert (keys[4, 1:4096 - 128 - 3] == 0).all()   # slot 0: no candidate
    assert (keys[5:] == 2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True])
def test_cuda_match_grouped_more_windows_than_a_wave(vn):
    """600 windows of 2 CUDA blocks each (2,048 slots a block): more
    blocks than the card holds at once (132 SMs, 6 blocks each)."""
    rng = np.random.default_rng(63)
    kinds = corpus.KINDS
    rows = []
    for b in range(600):
        n = int(rng.integers(0, 4096 - 128))
        data = corpus.make_raw(kinds[b % len(kinds)], n, rng)
        lo = int(rng.integers(0, n + 1))
        rows.append((data, n, lo, int(rng.integers(lo, 4097))))
    _match_cases(grouped_inputs(rows, 4096, vn,
                                native_runtime().match_group), vn)


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True])
def test_cuda_match_grouped_any_orders_and_bits(vn):
    """Orders that are any permutation and every candidate bit set: windows
    that wrap at N, slots below r that wrap to the end, candidates after
    their slot."""
    rng = np.random.default_rng(64)
    B, N = 3, 512
    a = dict(pads=rng.integers(0, 4, (B, N), dtype=np.uint8),
             n_reals=np.array([N, N - 100, 7], np.int32),
             los=np.array([0, 10, 0], np.int32),
             his=np.array([N, N - 200, N], np.int32),
             orders=np.stack([rng.permutation(N) for _ in range(B)])
             .astype(np.int32),
             oks=rng.integers(0, 256, (B, N), dtype=np.uint8))
    a["pads"][1, ::7] = 9
    _match_cases(a, vn)


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True])
def test_cuda_match_rows_across_block_and_window_boundaries(vn):
    """Windows of N = 2056 (one CUDA block of 2,048 slots and a ragged
    second), zero rows (every probed slot saturated) beside text and
    random rows, so the compacted rows cross block and window boundaries
    in every mix, and more windows than a wave of the card's CUDA
    blocks."""
    rng = np.random.default_rng(65)
    N = 2056
    rows = []
    for b in range(1000):
        n = int(rng.integers(0, N - 128))
        kind = b % 3
        data = (bytes(n) if kind == 0 else words(rng, N)[:n] if kind == 1
                else bytes(rng.integers(0, 256, n, dtype=np.uint8)))
        lo = int(rng.integers(0, 300))
        rows.append((data, n, lo, int(rng.integers(lo, N + 1))))
    keys, (offsets, matched, m_len, sat) = _match_cases(
        grouped_inputs(rows, N, vn, native_runtime().match_group), vn)
    counts = torch.diff(offsets.cpu(), dim=0)
    assert (counts[:, 1] > 300).sum() > 200 and (counts[:, 0] > 0).sum() > 200
    assert int(offsets[-1, 0]) == int((keys == 1).sum())


@pytest.mark.cuda
def test_cuda_match_rows_registers():
    """More than 3 CUDA blocks of 256 slots fit on an SM, with no spills."""
    attrs = MF.kernel_attrs()
    assert attrs["blocks_per_sm"] > 3 and attrs["local_bytes"] == 0, attrs


@pytest.mark.cuda
def test_cuda_device_frontend_end_to_end():
    """On a card: the device frontend launches the match kernel and both
    encode kernels and writes the native encoder's containers."""
    raws = [r for r, _ in corpus.small_batch(seed=22, n_fse=5, lo=3_000,
                                             hi=60_000)]
    nat = native_runtime()
    enc = TorchEncoder("cuda", frontend="device")
    before = {**KE.launches, **MF.launches}
    stats: dict = {}
    assert enc.encode_many(raws, stats) == [nat.encode_bytes(r) for r in raws]
    after = {**KE.launches, **MF.launches}
    assert all(after[k] > before[k] for k in before)
    assert all({"upload_ms", "kernel_ms", "download_ms"} <= set(d)
               for d in stats["detail_match"])
    big = max(raws, key=len)
    assert enc.encode_bytes(big) == nat.encode_bytes(big)


@pytest.mark.cuda
def test_cuda_step_memory_follows_the_shared_memory_limit():
    """The kernel library's placement: 32 KB to 128 KB row tables live in
    shared memory, the 288 KB pair table in device memory."""
    assert {b: P.step_memory(b) for b in P.STEP_BODIES} == {
        **{b: "shared" for b in P.STEP_BODIES}, "pair_64": "global"}
    assert P.cuda_lib.lib().lzt_probe_step_shared(len(P.STEP_BODIES)) == -1


PROBE_CASES = ([("probe_step", b) for b in P.STEP_BODIES]
               + [("probe_chain", b) for b in P.CHAIN_BODIES]
               + [("probe_tput", b) for b in P.TPUT_BODIES])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,body", PROBE_CASES,
                         ids=[f"{k}-{b}" for k, b in PROBE_CASES])
def test_cuda_probe_kernels_equal_plain_versions(kernel, body):
    """On a card: each probe body equals its plain version bit for bit, at
    the TPU tools' input ranges and at any int32 (wrap-around, signed
    shifts)."""
    rng = np.random.default_rng(31)
    i32 = np.iinfo(np.int32)

    def wide(shape):
        return torch.from_numpy(rng.integers(i32.min, i32.max + 1, shape,
                                             dtype=np.int64)
                                .astype(np.int32)).cuda()

    fn, ref = getattr(P, kernel), getattr(P, kernel + "_ref")
    if kernel == "probe_step":
        tw = P.STEP_BODIES[body]
        cases = (PS.inputs(body, 2, seed=31),
                 (wide((8, P.G * tw)), wide((8, P.G * 256)), wide((24, 128))))
        n = 8
    else:
        tab, x = (torch.from_numpy(rng.integers(0, 128, s).astype(np.int32))
                  .cuda() for s in ((8, 1024), (8, 128)))
        cases = ((tab, x), (wide((8, 1024)), wide((8, 128))))
        n = 3
    for args in cases:
        before = P.launches[kernel]
        got = fn(body, *args, n)
        torch.cuda.synchronize()
        assert P.launches[kernel] == before + 1
        assert torch.equal(got, ref(body, *args, n)), (kernel, body)


def _rebuild_on_card(args: dict):
    """The rebuild kernel against its plain version on the card (out and
    ok, every byte); the plain version is never taken for CUDA tensors."""
    args = {k: v.cuda() if torch.is_tensor(v) else v for k, v in args.items()}
    before = CR.launches["lz_rebuild"]
    out, ok = CR.lz_rebuild(**args)
    torch.cuda.synchronize()
    assert CR.launches["lz_rebuild"] == before + 1
    want_out, want_ok = CR.lz_rebuild_ref(**args)
    assert torch.equal(ok, want_ok)
    assert torch.equal(out, want_out)
    return out.cpu(), ok.cpu()


def _flat(containers):
    """lz_rebuild arguments (CPU) for containers given as (literals bytes,
    rows (n, 3), n_raw, segment length)."""
    lit = np.concatenate([np.frombuffer(c[0], np.uint8) for c in containers])
    rows = np.concatenate([np.asarray(c[1], np.int32).reshape(-1, 3)
                           for c in containers])

    def off(x):
        return torch.from_numpy(np.concatenate(([0], np.cumsum(x)))
                                .astype(np.int32))

    return dict(literals=torch.from_numpy(lit.copy()),
                lit_off=off([len(c[0]) for c in containers]),
                rows=torch.from_numpy(rows),
                row_off=off([len(np.asarray(c[1]).reshape(-1, 3))
                             for c in containers]),
                n_raw=torch.tensor([c[2] for c in containers],
                                   dtype=torch.int32),
                out_off=off([c[3] for c in containers]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", REBUILD_CASES)
def test_cuda_rebuild_equals_plain_on_seeded_batches(name):
    lits, rows, n_raw, n_out = rebuild_case(name, 71)
    _rebuild_on_card(CR.from_jax_rebuild_args(lits, rows, n_raw, n_out))


@pytest.mark.cuda
def test_cuda_rebuild_4mib_d1_run_and_raw_row():
    """A d = 1 run of 4 MiB after one literal (22 rounds), and a single RAW
    row of 4 MiB, in one batch."""
    n = 4 << 20
    body = bytes(np.random.default_rng(72).integers(0, 256, n,
                                                    dtype=np.uint8))
    out, ok = _rebuild_on_card(_flat([
        (b"\x07", [[1, n - 1, 1]], n, n),
        (body, [[n, 0, 0]], n, n)]))
    assert ok.all()
    assert bool((out[:n] == 7).all()) and out[n:].numpy().tobytes() == body


@pytest.mark.cuda
def test_cuda_rebuild_d_at_m_and_m_minus_1_every_row():
    rng = np.random.default_rng(73)
    conts = []
    for shift in (0, 1):
        rows, made = [], 0
        for _ in range(400):
            m = int(rng.integers(2, 70))
            rows.append([1, m, min(m - shift, made + 1)])
            made += 1 + m
        conts.append((bytes(rng.integers(0, 256, 400, dtype=np.uint8)),
                      rows, made, made))
    out, ok = _rebuild_on_card(_flat(conts))
    assert ok.all()


@pytest.mark.cuda
def test_cuda_rebuild_empty_and_invalid_containers():
    """Empty containers (no rows, with and without an output segment or a
    pool), one container alone (B = 1), and invalid rows: d = 0 and d < 0
    with m > 0, d past the bytes made, more literals than the pool, a total
    off n_raw, l or m past int16."""
    conts = [(b"", [], 0, 0), (b"abc", [], 0, 5), (b"", [[0, 0, 0]], 0, 3),
             (b"xy", [[2, 4, 0]], 6, 6), (b"xy", [[2, 4, -3]], 6, 6),
             (b"xy", [[2, 4, 3]], 6, 6), (b"xy", [[3, 1, 1]], 4, 4),
             (b"xyz", [[3, 2, 1]], 6, 6), (b"q" * 70000, [[70000, 70000, 7]],
                                           140000, 140000)]
    out, ok = _rebuild_on_card(_flat(conts))
    assert ok.tolist() == [True] * 3 + [False] * 5 + [True]
    _rebuild_on_card(_flat(conts[-1:]))
    _rebuild_on_card(_flat([(b"ab", [[2, 9, 1]], 11, 11)]))


@pytest.mark.cuda
def test_cuda_rebuild_more_blocks_than_a_wave():
    """Many containers of random sizes: more CUDA blocks than one launch's
    grid, so the grid-stride loops run several times."""
    rng = np.random.default_rng(74)
    conts = []
    for c in range(300):
        rows, made, used = [], 0, 0
        for _ in range(int(rng.integers(0, 60))):
            l = int(rng.integers(0, 30)) if made else int(rng.integers(1, 30))
            m = int(rng.integers(0, 3000))
            d = int(rng.integers(1, made + l + 1))
            rows.append([l, m, d])
            made, used = made + l + m, used + l
        conts.append((bytes(rng.integers(0, 256, used, dtype=np.uint8)),
                      rows, made, made))
    assert sum(c[3] for c in conts) > 132 * 16 * 256
    out, ok = _rebuild_on_card(_flat(conts))
    assert ok.all()


@pytest.mark.cuda
def test_cuda_rebuild_tile_boundaries():
    """Tile boundaries (every 4096 output positions) inside a row, at a
    row's first byte, at a container boundary, and where empty containers
    (with and without rows, pools or segments) sit exactly on one."""
    tile = CR.TILE
    rng = np.random.default_rng(75)
    lit = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    conts = [(lit[:10], [[10, tile - 10 - 700, 3], [0, 700, 700],
                         [0, 5000, 4000]], 2 * tile + 904, 2 * tile + 904),
             (lit[:9], [[9, tile - 9 - 904 + tile, 9]], tile - 904 + tile,
              tile - 904 + tile),
             (b"", [], 0, 0), (b"", [[0, 0, 0]], 0, 0), (lit, [], 0, 0),
             (lit[:5], [[5, 3000, 2], [0, 0, 0], [0, 0, 0], [0, 2000, 1]],
              5005, 5005)]
    out, ok = _rebuild_on_card(_flat(conts))
    assert ok.all()
    assert int(_flat(conts)["out_off"][2]) % tile == 0


@pytest.mark.cuda
def test_cuda_rebuild_more_tiles_than_a_wave():
    """8 MiB of output over containers of random sizes: many more tiles
    than the card holds at once, and more open positions than one
    launch of a round has threads."""
    rng = np.random.default_rng(76)
    conts, total = [], 0
    while total < 8 << 20:
        rows, made, used = [], 0, 0
        for _ in range(int(rng.integers(1, 400))):
            l = int(rng.integers(0, 30)) if made else int(rng.integers(1, 30))
            m = int(rng.integers(0, 600))
            d = int(rng.integers(1, made + l + 1))
            rows.append([l, m, d])
            made, used = made + l + m, used + l
        conts.append((bytes(rng.integers(0, 256, used, dtype=np.uint8)),
                      rows, made, made))
        total += made
    detail: dict = {}
    args = {k: v.cuda() for k, v in _flat(conts).items()}
    out, ok = CR.lz_rebuild(**args, detail=detail)
    assert torch.equal(out, CR.lz_rebuild_ref(**args)[0]) and bool(ok.all())
    counts = detail["unresolved"]
    assert counts[0] > 132 * 16 * 256 and counts[-1] == 0
    assert all(a >= b for a, b in zip(counts, counts[1:]))


@pytest.mark.cuda
def test_cuda_rebuild_chain_across_many_rows():
    """Each row copies the row before it (d = m), 3,000 rows deep, beside a
    periodic run that copies across rows with d < m: chains of thousands
    of links that no row folds away, across many tiles."""
    rng = np.random.default_rng(77)
    rows, made = [[5, 0, 0]], 5
    for _ in range(3000):
        m = int(rng.integers(2, 40))
        rows.append([0, m, min(m, made)])
        made += m
    per, pmade = [[7, 0, 0]], 7
    for _ in range(2000):
        m = int(rng.integers(8, 30))
        per.append([0, m, 7])
        pmade += m
    out, ok = _rebuild_on_card(_flat([(b"hello", rows, made, made),
                                      (b"abcdefg", per, pmade, pmade)]))
    assert ok.all()
    assert out[made:].numpy().tobytes() == (b"abcdefg" * pmade)[:pmade]


@pytest.mark.cuda
def test_cuda_rebuild_registers():
    """No kernel of the rebuild spills; the tile kernel fits more than one
    CUDA block an SM."""
    attrs = CR.kernel_attrs()
    assert all(a["local_bytes"] == 0 for a in attrs.values()), attrs
    assert attrs["lzr_tile"]["blocks_per_sm"] > 1, attrs


@pytest.mark.cuda
def test_cuda_rebuild_raises_at_2_31_output_positions():
    """An output total of 2**31 positions or more raises before anything
    is allocated or launched, whether the caller passes the total or the
    wrapper reads it from out_off."""
    args = {k: v.cuda() for k, v in _flat([(b"a", [[1, 0, 0]], 1, 1)] * 2)
            .items()}
    before = CR.launches["lz_rebuild"]
    for last in (2**31 - 1, 2**31 - 2):
        args["out_off"] = torch.tensor([0, 1, last], dtype=torch.int32,
                                       device="cuda")
        with pytest.raises(ValueError, match="2\\*\\*31"):
            CR.lz_rebuild(**args, n_out=last + 2)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        CR.lz_rebuild(**args, n_out=2**31)
    assert CR.launches["lz_rebuild"] == before


@pytest.mark.cuda
def test_cuda_decoder_device_rebuild_end_to_end():
    """On a card: use_native_rebuild=False runs both decode kernels and the
    rebuild kernel, and its flatten equals the CPU decoder's."""
    mixed = corpus.small_batch(seed=21, n_fse=5, lo=3_000, hi=16_000)
    sources = [c for _, c in mixed]
    dec = TorchDecoder("cuda", use_native_rebuild=False)
    before = {**K.launches, **CR.launches}
    stats: dict = {}
    assert dec.decode_many(sources, stats) == [r for r, _ in mixed]
    assert stats.get("fallbacks", 0) == 0
    after = {**K.launches, **CR.launches}
    assert all(after[k] == before[k] + 1 for k in before)
    assert {"upload_ms", "kernels_ms", "flatten_ms", "rebuild_ms",
            "download_ms", "out_download_ms"} == set(stats["detail_device"])
    got = dec.rebuild_args(sources)
    want = TorchDecoder("cpu", use_native_rebuild=False).rebuild_args(sources)
    assert got.keys() == want.keys()
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k].cpu(), want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.cuda
@pytest.mark.parametrize("native", [True, False])
def test_cuda_decoder_scan_path(native):
    """use_kernels=False on a card: tables and scans as torch ops on the
    device, then either rebuild."""
    mixed = corpus.small_batch(seed=24, n_fse=2, lo=2_000, hi=5_000)
    dec = TorchDecoder("cuda", use_kernels=False, use_native_rebuild=native)
    before = dict(CR.launches)
    stats: dict = {}
    assert dec.decode_many([c for _, c in mixed], stats) == [
        r for r, _ in mixed]
    assert stats.get("fallbacks", 0) == 0
    assert CR.launches["lz_rebuild"] == before["lz_rebuild"] + (not native)


@pytest.mark.cuda
def test_cuda_table_build_equals_native():
    """The device table build (torch ops on the card) equals the native
    build_tables3_batch on corpus weights and hand-built latch weights."""
    ws = [d.weights for d in blocks_of(corpus.small_batch(seed=12, n_fse=6))]
    w = np.zeros(360, np.int64)
    w[[0, 20, 40, 41, 104]] = (1, 64, 100, 50, 7)
    w16 = np.ascontiguousarray(np.stack(ws + [w, w * 0]), np.uint16)
    nb = len(w16)
    v, u3, tot = (np.zeros((nb, 384), np.int32), np.zeros((nb, 384), np.int32),
                  np.zeros(nb, np.int32))
    ident = np.arange(nb, dtype=np.int32)
    native_runtime().build_tables3_batch(w16, ident, ident, v, u3, tot)
    got = TB.build_decode_tables_v3(torch.from_numpy(w16.astype(np.int32))
                                    .cuda())
    for g, want in zip(got, (v, u3, tot)):
        assert np.array_equal(g.cpu().numpy(), want)


# --- several devices (parallel/mesh.py) ----------------------------------------

def _meshes(kind: str):
    """``three_on_one``: cuda:0 three times (uneven shards after padding);
    ``all_cards``: every card, skipped with fewer than two."""
    if kind == "three_on_one":
        return make_mesh(["cuda:0"] * 3)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    return make_mesh(None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["three_on_one", "all_cards"])
def test_cuda_mesh_decoder_equals_single_device(kind):
    """``TorchDecoder(mesh=)`` gives the unsharded decoder's bytes, each
    decode kernel launched once a shard, and the same kernel outputs."""
    mesh = _meshes(kind)
    mixed = corpus.small_batch(seed=31, n_fse=7, lo=3_000, hi=60_000)
    sources = [c for _, c in mixed]
    dec = TorchDecoder("cuda", mesh=mesh)
    before = dict(K.launches)
    stats: dict = {}
    got = dec.decode_many(sources, stats)
    assert got == TorchDecoder("cuda").decode_many(sources)
    assert got == [r for r, _ in mixed]
    assert stats.get("fallbacks", 0) == 0
    assert all(K.launches[k] == before[k] + mesh.size + 1 for k in before)
    assert len(stats["detail_device"]["shard_kernels_ms"]) == mesh.size


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["three_on_one", "all_cards"])
def test_cuda_sharded_kernels_equal_unsharded(kind):
    """``sharded_pallas_entropy_decode``, ``sharded_rebuild`` and
    ``sharded_grouped_match`` equal the unsharded kernels bit for bit."""
    mesh = _meshes(kind)
    lit, lmd = TorchDecoder("cuda").kernel_args(
        [c for _, c in corpus.small_batch(seed=32, n_fse=8)])
    arrays = K.to_jax_decode_args(lit, lmd)
    pad = -lit["tables"].shape[0] % mesh.size
    arrays = {k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
              for k, v in arrays.items()}
    n_lit = int(((lit["num"].long() + 3) // 4).max())
    n_lmd = int(lmd["num"].max())
    got = sharded_pallas_entropy_decode(mesh, arrays, n_lit, n_lmd)
    w_lit = K.decode_literals(**K.from_jax_decode_args(
        "literals", arrays["u3_tabs"], arrays["lit_words"],
        arrays["lit_states"], arrays["lit_pos"], arrays["lit_num"],
        arrays["lit_tot"], device="cuda"))
    w_lmd = K.decode_lmds(**K.from_jax_decode_args(
        "lmds", arrays["v_tabs"], arrays["lmd_words"], arrays["lmd_states"],
        arrays["lmd_pos"], arrays["lmd_num"], device="cuda"))
    for g, w in zip(got, (w_lit[0], w_lmd[0], w_lmd[1], w_lit[1], w_lit[2],
                          w_lmd[2], w_lmd[3])):
        assert torch.equal(g.cuda(), w)

    # two containers and two windows a shard
    lits, rows, n_raw, n_out = rebuild_case("overlap", seed=33,
                                            B=2 * mesh.size)
    got = sharded_rebuild(mesh, lits, rows, n_raw, n_out)
    want = CR.lz_rebuild(**CR.from_jax_rebuild_args(lits, rows, n_raw, n_out,
                                                    device="cuda"))
    assert torch.equal(got[0].cuda().reshape(-1), want[0])
    assert torch.equal(got[1].cuda(), want[1])

    a = grouped_inputs((window_rows(4096, seed=34) * 2)[:2 * mesh.size],
                       4096, False, native_runtime().match_group)
    got = sharded_grouped_match(mesh, **a)
    want = MF.match_rows(**{k: torch.from_numpy(v).cuda()
                            for k, v in a.items()}, vn=False)
    for g, w in zip(got, want):
        assert torch.equal(g.cuda(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["three_on_one", "all_cards"])
def test_cuda_mesh_encoder_equals_native(kind):
    """``TorchEncoder(mesh=)`` writes the native encoder's containers, the
    match kernel launched once a shard a window size."""
    mesh = _meshes(kind)
    raws = [r for r, _ in corpus.small_batch(seed=35, n_fse=5, lo=3_000,
                                             hi=60_000)]
    nat = native_runtime()
    enc = TorchEncoder("cuda", mesh=mesh)
    before = MF.launches["match_grouped"]
    stats: dict = {}
    assert enc.encode_many(raws, stats) == [nat.encode_bytes(r) for r in raws]
    assert MF.launches["match_grouped"] == before + mesh.size * len(
        stats["detail_match"])


@pytest.mark.cuda
def test_cuda_dryrun_multichip():
    assert dryrun_multichip(4)["devices"] == [
        f"cuda:{i % torch.cuda.device_count()}" for i in range(4)]


def _chunk_batch():
    raws = [r for r, _ in corpus.small_batch(seed=24, n_fse=6, lo=40_000,
                                             hi=120_000)]
    pat = np.random.default_rng(24).integers(0, 256, 13, np.uint8).tobytes()
    return raws + [(pat * 4000)[:45_000]]   # period-split alternatives


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_cuda_chunked_encode_launches_once_a_chunk(n_chunks, monkeypatch):
    """``LZT_ENC_CHUNKS``: the native encoder's containers, each encode
    kernel launched once a chunk, ``pipeline_chunks`` the count."""
    raws = _chunk_batch()
    nat = native_runtime()
    monkeypatch.setenv("LZT_ENC_CHUNKS", str(n_chunks))
    enc = TorchEncoder("cuda")
    enc.encode_many(raws)
    before = dict(KE.launches)
    stats: dict = {}
    assert enc.encode_many(raws, stats) == [nat.encode_bytes(r) for r in raws]
    assert stats["pipeline_chunks"] == n_chunks
    assert all(KE.launches[k] == before[k] + n_chunks for k in before)
    assert set(stats["detail_device"]) == {"upload_ms", "kernels_ms",
                                           "download_ms"}
    assert "emit_dispatch" in stats


@pytest.mark.cuda
def test_cuda_chunked_encode_pool_overflow_in_the_second_chunk(monkeypatch):
    """The second chunk overflows the pool while the first chunk's
    emission is in flight: the encoder waits for it, doubles the pool and
    stages every chunk again; the containers do not change."""
    raws = _chunk_batch()
    monkeypatch.setenv("LZT_ENC_CHUNKS", "2")
    got, asked, spans, first = overflow_in_second_chunk("cuda", raws,
                                                        monkeypatch)
    assert asked == [first[0][1] + 1, 2 * (first[0][1] + 1)]
    assert spans == [first[0]] + first
    assert got == [native_runtime().encode_bytes(r) for r in raws]


@pytest.mark.cuda
def test_cuda_argsort_branch_on_a_two_window_source(monkeypatch):
    """``LZT_DEV_GROUPED=0``: ``find_matches_compact`` on the card, one
    window size at a time, then emission through both encode kernels."""
    rng = np.random.default_rng(30)
    src = corpus.make_raw("text", ME.WINDOW_STRIDE + 100_000, rng)
    monkeypatch.setenv("LZT_DEV_GROUPED", "0")
    enc = TorchEncoder("cuda", frontend="device")
    before = {**KE.launches, **MF.launches}
    stats: dict = {}
    assert enc.encode_many([src], stats) == [native_runtime().encode_bytes(
        src)]
    assert [w[2] for w in enc.windows([src])] == [0, ME.WINDOW_CTX]
    assert all(KE.launches[k] == before[k] + 1 for k in KE.launches)
    assert MF.launches["match_grouped"] == before["match_grouped"]
    assert all({"upload_ms", "kernel_ms", "download_ms"} <= set(d)
               for d in stats["detail_match"])


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", ["1", "0"])
def test_cuda_host_emission_on_a_two_window_source(grouped, monkeypatch):
    """``device_emission=False``: the device windows' matches on the card
    (the grouped kernel, or the argsort branch), then ``select_emit_fse``
    on the host; no encode kernel runs."""
    rng = np.random.default_rng(32)
    sources = [corpus.make_raw("text", ME.WINDOW_STRIDE + 100_000, rng),
               corpus.make_raw("html", 60_000, rng), b"tiny"]
    monkeypatch.setenv("LZT_DEV_GROUPED", grouped)
    enc = TorchEncoder("cuda", device_emission=False)
    assert enc.frontend == "device"
    before = {**KE.launches, **MF.launches}
    stats: dict = {}
    nat = native_runtime()
    assert enc.encode_many(sources, stats) == [nat.encode_bytes(s)
                                               for s in sources]
    assert enc.last_emission == "host" and "select_emit" in stats
    assert "detail_device" not in stats
    assert all(KE.launches[k] == before[k] for k in KE.launches)
    n_sizes = len({w[4] for w in enc.windows(sources)})
    assert MF.launches["match_grouped"] == before["match_grouped"] + (
        n_sizes if grouped == "1" else 0)
    assert enc.encode_bytes(sources[0]) == nat.encode_bytes(sources[0])
