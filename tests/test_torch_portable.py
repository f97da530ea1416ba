"""The portable decode paths against the JAX package.

The decode-table builds (``ops/table_build.py``) and the stream scans
(``ops/fse_decode.py``) must equal their JAX twins exactly, and the table
builds the port's native builders; ``TorchDecoder("cpu")`` with each of
``use_kernels`` and ``use_native_rebuild`` must decode a mixed FSE / LZVN /
RAW / empty batch to the raw inputs and to what ``TpuDecoder(use_pallas=
False)`` decodes, raise as it raises on malformed containers, and give the
spec layer's result (with a fallback) on corrupted payloads. The device
flatten must build the rows and literal pools the JAX decoder's host
flatten builds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzfse_rust_tpu.models.decoder import TpuDecoder
from lzfse_rust_tpu.ops import fse_decode as JF
from lzfse_rust_tpu.ops import lz_rebuild as JL
from lzfse_rust_tpu.ops import table_build as JT
from lzfse_rust_tpu.spec import container as jax_container
from lzfse_rust_tpu_torch import TorchDecoder
from lzfse_rust_tpu_torch.base import constants as C
from lzfse_rust_tpu_torch.ops import fse_decode as FD
from lzfse_rust_tpu_torch.ops import table_build as TB
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.spec import container as spec_container
from lzfse_rust_tpu_torch.utils import corpus
from torch_kit import blocks_of

OPTIONS = [(True, True), (True, False), (False, True), (False, False)]
OPTION_IDS = ["kernels-native", "kernels-device", "scan-native",
              "scan-device"]


@pytest.fixture(scope="module")
def mixed():
    return corpus.small_batch(seed=31, n_fse=4, lo=3_000, hi=14_000)


@pytest.fixture(scope="module")
def blocks(mixed):
    return blocks_of(mixed)


def _weights(kind: str, blocks) -> np.ndarray:
    """(n, 360) int32 weights: corpus blocks', all zero, hand-built
    classes whose totals stay below their state counts (latch entries) or
    fill them with one symbol, or random ones within the state counts."""
    if kind == "corpus":
        return np.stack([d.weights for d in blocks]).astype(np.int32)
    w = np.zeros((4, C.N_WEIGHTS), np.int32)
    if kind == "latch":
        w[0, [0, 20, 40, 41, 104]] = (1, 64, 100, 50, 7)
        w[1, [3, 25, 50, 200]] = (63, 1, 255, 1000)
        w[2, C.D_TOP:C.U_TOP] = 3
        w[3, [C.L_TOP - 1, C.M_TOP - 1, C.D_TOP - 1, C.U_TOP - 1]] = (
            C.L_STATES, C.M_STATES, C.D_STATES, C.U_STATES)
    elif kind == "random":
        rng = np.random.default_rng(4)
        for lo, hi, n in ((0, C.L_TOP, C.L_STATES), (C.L_TOP, C.M_TOP,
                                                      C.M_STATES),
                          (C.M_TOP, C.D_TOP, C.D_STATES),
                          (C.D_TOP, C.U_TOP, C.U_STATES)):
            for r in range(4):
                p = rng.dirichlet(np.ones(hi - lo) * 0.3)
                w[r, lo:hi] = np.floor(p * n * rng.uniform(0.5, 1.0))
    return w


@pytest.mark.parametrize("kind", ["corpus", "zero", "latch", "random"])
@pytest.mark.parametrize("fn", ["build_decode_tables",
                                "build_decode_tables_v3"])
def test_table_build_equals_jax(fn, kind, blocks):
    w = _weights(kind, blocks)
    want = [np.asarray(x) for x in getattr(JT, fn)(jnp.asarray(w))]
    got = [x.numpy() for x in getattr(TB, fn)(torch.from_numpy(w))]
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and np.array_equal(g, x)


@pytest.mark.parametrize("kind", ["corpus", "zero", "latch", "random"])
def test_table_build_equals_native(kind, blocks):
    """Both table layouts equal the port's native builders
    (``build_tables_batch``, ``build_tables3_batch``), slot for slot."""
    w = _weights(kind, blocks)
    w16 = np.ascontiguousarray(w.astype(np.uint16))
    n = len(w)
    slots = np.arange(n, dtype=np.int32)[::-1].copy()
    nat = native_runtime()
    v, u = np.zeros((n, 384), np.int32), np.zeros((n, 1024), np.int32)
    nat.build_tables_batch(w16, slots, slots, v, u)
    v3, u3, tot = (np.zeros((n, 384), np.int32), np.zeros((n, 384), np.int32),
                   np.zeros(n, np.int32))
    nat.build_tables3_batch(w16, slots, slots, v3, u3, tot)
    vp, _, up = TB.build_decode_tables(torch.from_numpy(w))
    assert np.array_equal(vp.numpy(), v[slots])
    assert np.array_equal(up.numpy(), u[slots])
    for g, x in zip(TB.build_decode_tables_v3(torch.from_numpy(w)),
                    (v3, u3, tot)):
        assert np.array_equal(g.numpy(), x[slots])


def _scan_inputs(blocks):
    B = len(blocks)
    w_l = max(len(d.lit_payload) for d in blocks) + 8
    w_m = max(len(d.lmd_payload) for d in blocks) + 8
    a = dict(litp=np.zeros((B, w_l), np.uint8), lmdp=np.zeros((B, w_m),
                                                              np.uint8),
             lit_pos=np.zeros(B, np.int32), lmd_pos=np.zeros(B, np.int32),
             lit_states=np.zeros((B, 4), np.int32),
             lmd_states=np.zeros((B, 3), np.int32),
             lit_num=np.zeros(B, np.int32), lmd_num=np.zeros(B, np.int32),
             weights=np.stack([d.weights for d in blocks]).astype(np.int32))
    for i, d in enumerate(blocks):
        a["litp"][i, :len(d.lit_payload)] = np.frombuffer(d.lit_payload,
                                                          np.uint8)
        a["lmdp"][i, :len(d.lmd_payload)] = np.frombuffer(d.lmd_payload,
                                                          np.uint8)
        a["lit_pos"][i] = len(d.lit_payload) * 8 - d.block.literal.bits
        a["lmd_pos"][i] = len(d.lmd_payload) * 8 - d.block.lmd.bits
        a["lit_states"][i] = d.block.literal.state
        a["lmd_states"][i] = np.add(d.block.lmd.state,
                                    (0, C.L_STATES, C.L_STATES + C.M_STATES))
        a["lit_num"][i] = d.block.literal.num
        a["lmd_num"][i] = d.block.lmd.num
    return a


def test_bytes_to_windows_equals_jax(blocks):
    p = _scan_inputs(blocks[:3])["litp"]
    want = np.asarray(JF.bytes_to_windows(jnp.asarray(p)))
    got = FD.bytes_to_windows(torch.from_numpy(p))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.view(np.int32))


@pytest.mark.parametrize("steps", ["short", "full"])
def test_scans_equal_jax(steps, blocks):
    """Both scans on a few small blocks: at a step count that stops inside
    every block (states and positions mid-stream) and at the batch's
    largest count."""
    a = _scan_inputs(blocks[:4])
    n_l = 37 if steps == "short" else int(((a["lit_num"] + 3) // 4).max())
    n_m = 29 if steps == "short" else int(a["lmd_num"].max())
    vp, vb, up = JT.build_decode_tables(jnp.asarray(a["weights"]))
    J = jnp.asarray
    want = (*JF.decode_literals_batch(
        up, JF.bytes_to_windows(J(a["litp"])), J(a["lit_states"]),
        J(a["lit_pos"]), J(a["lit_num"]), n_l),
            *JF.decode_lmds_batch(
        vp, vb, JF.bytes_to_windows(J(a["lmdp"])), J(a["lmd_states"]),
        J(a["lmd_pos"]), J(a["lmd_num"]), n_m))
    T = torch.from_numpy
    tvp, tvb, tup = TB.build_decode_tables(T(a["weights"]))
    got = (*FD.decode_literals_batch(
        tup, FD.bytes_to_windows(T(a["litp"])), T(a["lit_states"]),
        T(a["lit_pos"]), T(a["lit_num"]), n_l),
           *FD.decode_lmds_batch(
        tvp, tvb, FD.bytes_to_windows(T(a["lmdp"])), T(a["lmd_states"]),
        T(a["lmd_pos"]), T(a["lmd_num"]), n_m))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    if steps == "full":   # every stream ran to its end and checks clean
        assert (got[1] == 0).all()
        assert (got[4] == torch.tensor([0, C.L_STATES,
                                        C.L_STATES + C.M_STATES])).all()


@pytest.fixture(scope="module")
def jax_results(mixed):
    sources = [c for _, c in mixed]
    out = {}
    for native in (True, False):
        stats: dict = {}
        got = TpuDecoder(use_pallas=False,
                         use_native_rebuild=native).decode_many(sources, stats)
        out[native] = (got, stats.get("fallbacks", 0))
    return out


@pytest.mark.parametrize("kernels,native", OPTIONS, ids=OPTION_IDS)
def test_decoder_options_equal_tpu_decoder(kernels, native, mixed,
                                           jax_results):
    sources = [c for _, c in mixed]
    assert {b"bvx2", b"bvxn", b"bvx-", b"bvx$"} <= {c[:4] for c in sources}
    stats: dict = {}
    got = TorchDecoder("cpu", use_kernels=kernels,
                       use_native_rebuild=native).decode_many(sources, stats)
    want, jax_fallbacks = jax_results[native]
    assert got == want == [r for r, _ in mixed]
    assert stats.get("fallbacks", 0) == 0 == jax_fallbacks
    assert {"parse", "prep", "device", "flatten", "rebuild"} <= set(stats)


def _outcome(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the exception is the result
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("kernels,native", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("case", ["truncated", "trailing", "bad_magic",
                                  "zero_header", "empty_input"])
def test_malformed_raises_as_tpu_decoder(case, kernels, native, mixed):
    good = next(c for _, c in mixed if c[:4] == b"bvx2")
    bad = {"truncated": good[:len(good) // 2],
           "trailing": good + b"\x00\x01",
           "bad_magic": b"bvxZ" + good[4:],
           "zero_header": b"bvx2" + b"\x00" * 40,
           "empty_input": b""}[case]
    ref = TpuDecoder(use_pallas=False, use_native_rebuild=native)
    want = _outcome(lambda: ref.decode_many([good, bad]))
    got = _outcome(lambda: TorchDecoder(
        "cpu", use_kernels=kernels,
        use_native_rebuild=native).decode_many([good, bad]))
    assert isinstance(want, tuple) and got == want


@pytest.mark.parametrize("kernels,native", OPTIONS[1:], ids=OPTION_IDS[1:])
@pytest.mark.parametrize("seed", range(3))
def test_corrupt_payload_matches_spec(seed, kernels, native, mixed):
    """A flipped payload bit gets past the parse; the stream checks, the
    literal count or the rebuild's checks must then send the container to
    the spec layer, so the result (bytes or exception) is the spec layer's
    (and the JAX package's), with a fallback when it raises."""
    rng = np.random.default_rng(seed)
    fse = [c for _, c in mixed if c[:4] == b"bvx2"]
    c = bytearray(fse[seed % len(fse)])
    at = int(rng.integers(len(c) // 2, len(c) - 4))
    c[at] ^= 1 << int(rng.integers(8))
    c = bytes(c)
    want = _outcome(lambda: spec_container.decode_bytes(c))
    assert want == _outcome(lambda: jax_container.decode_bytes(c))
    stats: dict = {}
    got = _outcome(lambda: TorchDecoder(
        "cpu", use_kernels=kernels,
        use_native_rebuild=native).decode_many([c], stats)[0])
    assert got == want
    if isinstance(want, tuple):
        assert stats.get("fallbacks", 0) == 1


def test_device_flatten_equals_host_flatten(mixed, blocks):
    """The kernel path's device flatten (``rebuild_args``) gives each
    container the rows and the literal pool that the JAX decoder's host
    flatten gives it (decoder.py:1137-1174) from the JAX scans' outputs:
    FSE rows with distances substituted per block, only the literals the
    rows consume, LZVN rows and RAW rows between them."""
    sources = [c for _, c in mixed]
    a = _scan_inputs(blocks)
    n_l = int(((a["lit_num"] + 3) // 4).max())
    n_m = int(a["lmd_num"].max())
    J = jnp.asarray
    vp, vb, up = JT.build_decode_tables(J(a["weights"]))
    lits = np.asarray(JF.decode_literals_batch(
        up, JF.bytes_to_windows(J(a["litp"])), J(a["lit_states"]),
        J(a["lit_pos"]), J(a["lit_num"]), n_l)[0])
    lmds = np.array(JF.decode_lmds_batch(
        vp, vb, JF.bytes_to_windows(J(a["lmdp"])), J(a["lmd_states"]),
        J(a["lmd_pos"]), J(a["lmd_num"]), n_m)[0])
    lmds[:, :, 2] = np.asarray(JL.substitute_distances(J(lmds[:, :, 2])))
    from lzfse_rust_tpu_torch.models.decoder import _parse_container
    args = TorchDecoder("cpu").rebuild_args(sources)
    ro, lo = args["row_off"].numpy(), args["lit_off"].numpy()
    rows, pool = args["rows"].numpy(), args["literals"].numpy()
    fse: list = []
    for ci, src in enumerate(sources):
        want_rows, want_lits = [np.zeros((0, 3), np.int32)], []
        for part in _parse_container(src, ci, fse).parts:
            if part[0] == "fse":
                bi = part[1]
                r = lmds[bi, :a["lmd_num"][bi]]
                want_rows.append(r)
                want_lits.append(lits[bi, :int(r[:, 0].sum())])
            else:
                want_rows.append(part[1])
                want_lits.append(np.frombuffer(part[2], np.uint8))
        assert np.array_equal(rows[ro[ci]:ro[ci + 1]],
                              np.concatenate(want_rows))
        assert pool[lo[ci]:lo[ci + 1]].tobytes() == b"".join(
            x.tobytes() for x in want_lits)
    assert len(fse) == len(blocks)


@pytest.mark.parametrize("kernels,native", OPTIONS, ids=OPTION_IDS)
def test_batch_without_fse_blocks(kernels, native):
    """LZVN, RAW and empty containers only: no FSE block reaches the
    kernels or the scans, and an empty batch decodes to nothing."""
    pairs = [(r, corpus.encode(r)) for r in
             (b"abcabcabc" * 20, bytes(range(256)) * 3, b"")]
    pairs.append((b"", corpus.EMPTY))
    assert not any(c[:4] == b"bvx2" for _, c in pairs)
    dec = TorchDecoder("cpu", use_kernels=kernels, use_native_rebuild=native)
    assert dec.decode_many([c for _, c in pairs]) == [r for r, _ in pairs]
    assert dec.decode_many([]) == []


def test_copy_segments_in_pieces_on_threads():
    """The device rebuild's last host copy: segments of a host buffer, some
    longer than one 1 MiB piece, some empty, into new bytes objects by a
    pool of threads."""
    from concurrent.futures import ThreadPoolExecutor

    from lzfse_rust_tpu_torch.models.decoder import copy_segments
    rng = np.random.default_rng(6)
    buf = rng.integers(0, 256, (3 << 20) + 77, dtype=np.uint8)
    cuts = [0, 5, 5, (1 << 20) + 9, (3 << 20) + 1, len(buf)]
    spans = list(zip(cuts[:-1], cuts[1:]))
    with ThreadPoolExecutor(4) as pool:
        got = copy_segments(buf.ctypes.data, spans, pool)
    assert [type(g) for g in got] == [bytes] * len(spans)
    assert got == [buf[a:b].tobytes() for a, b in spans]
