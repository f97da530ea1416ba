"""The device match finder (``TorchEncoder(frontend="device")``) against the
JAX package's.

On the CPU the port runs the grouped-match kernel's plain version. Inputs
are made from seeds with numpy and handed to both sides; every result is an
integer, so every comparison is exact (tolerance 0):

* ``grouped_compact_ref`` against ``find_matches_grouped_compact`` (plain
  ``jax.jit`` on the CPU; no Pallas in it) on windows with long runs
  (saturation), matches that end at ``n_real``, random bytes, an all-zero
  row and ``n_real < 4``, each side grouping with its own
  ``native.match_group``; ``take_sat_cols`` against its JAX twin;
  ``match_rows`` (the kernel's entry, its plain version on the CPU)
  against ``find_matches_grouped_compact``, then ``take_sat_cols``, then
  ``np.flatnonzero`` on the keys, as the encoder did with the JAX
  outputs;
* ``_windows_compact_grouped`` and ``_device_matches`` against
  ``TpuEncoder``'s and the spec layer's ``find_matches``;
* ``encode_many`` and ``encode_bytes`` against ``native.encode_bytes`` and
  ``TpuEncoder(device_emission=True, frontend="device")`` with its Pallas
  kernels in interpret mode; a two-window input against the native
  encoder.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from lzfse_rust_tpu.models.encoder import TpuEncoder
from lzfse_rust_tpu.ops import match_find_tpu as JMF
from lzfse_rust_tpu.runtime import native as jax_native
from lzfse_rust_tpu_torch import TorchEncoder
from lzfse_rust_tpu_torch.base import constants as C
from lzfse_rust_tpu_torch.models import encoder as M
from lzfse_rust_tpu_torch.ops import match_find as MF
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.spec.match_find import find_matches
from lzfse_rust_tpu_torch.utils import corpus
from torch_kit import grouped_inputs, window_rows, words

DEVICE_STAGES = {"small", "win_prep", "matchfind", "arbitrate", "merge",
                 "select", "emit_prep", "emit_kernels", "pack"}


@pytest.fixture(scope="module")
def nat():
    return native_runtime()


@pytest.fixture(scope="module")
def enc():
    return TorchEncoder("cpu", frontend="device")


@pytest.fixture
def interpret(monkeypatch):
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("N", [4096, 8192])
@pytest.mark.parametrize("vn", [False, True])
def test_grouped_compact_equals_jax(N, vn, nat):
    rows = window_rows(N, seed=N + vn)
    ours = grouped_inputs(rows, N, vn, nat.match_group)
    theirs = grouped_inputs(rows, N, vn, jax_native.match_group)
    want = JMF.find_matches_grouped_compact(
        *(jnp.asarray(theirs[k]) for k in ("pads", "n_reals", "los", "his",
                                           "orders", "oks")), vn)
    got = MF.grouped_compact_ref(**{k: torch.from_numpy(v)
                                    for k, v in ours.items()}, vn=vn)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    keys = got[0].numpy()
    # the rows hold what they were built for: saturated slots in the run
    # and zero rows, a truncated match at the tail's end, (almost) nothing
    # in the random row and nothing below n_real 4
    assert (keys[1] == 0).any() and (keys[4] == 0).any()
    assert (keys[0] == 1).any() and (keys[2] == 0).any()
    assert (keys[3] == 2).mean() > 0.99 and (keys[5:] == 2).all()
    tail_end = rows[2][1]
    assert ((ours["orders"][2] + got[4][2].numpy() >= tail_end)
            & (got[3][2].numpy() >= 0)).any()


def test_take_sat_cols_equals_jax():
    rng = np.random.default_rng(5)
    B, N, S = 3, 512, 37
    cands = rng.integers(-1, N, (B, C.HASH_WIDTH, N)).astype(np.int32)
    lcps = rng.integers(0, 65, (B, C.HASH_WIDTH, N)).astype(np.int32)
    idx = rng.integers(0, N, (B, S)).astype(np.int32)
    idx[1, 20:] = 0
    want = JMF.take_sat_cols(jnp.asarray(cands), jnp.asarray(lcps),
                             jnp.asarray(idx))
    got = MF.take_sat_cols(torch.from_numpy(cands), torch.from_numpy(lcps),
                           torch.from_numpy(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


ARGS = ("pads", "n_reals", "los", "his", "orders", "oks")


def _jax_rows(a: dict, vn: bool):
    """What the encoder read of the JAX outputs: per window, the key-1
    slots with their winners and the key-0 slots with their candidate
    columns from ``take_sat_cols``, found by ``np.flatnonzero``."""
    keys, bc, bl, cands, lcps = (np.asarray(x) for x in
                                 JMF.find_matches_grouped_compact(
                                     *(jnp.asarray(a[k]) for k in ARGS), vn))
    sat_idx = [np.flatnonzero(k == 0) for k in keys]
    mat_idx = [np.flatnonzero(k == 1) for k in keys]
    idx = np.zeros((len(keys), max(map(len, sat_idx))), np.int32)
    for r, s in enumerate(sat_idx):
        idx[r, :len(s)] = s
    cs, ls = (np.asarray(x) for x in JMF.take_sat_cols(
        jnp.asarray(cands), jnp.asarray(lcps), jnp.asarray(idx)))
    counts = np.array([[len(m), len(s)] for m, s in zip(mat_idx, sat_idx)])
    offsets = np.concatenate(([[0, 0]], np.cumsum(counts, 0))).astype(np.int32)
    matched = np.concatenate([np.stack((m, bc[r][m]), 1)
                              for r, m in enumerate(mat_idx)]).astype(np.int32)
    m_len = np.concatenate([bl[r][m] for r, m in enumerate(mat_idx)])
    sat = np.concatenate([np.concatenate((s[:, None], cs[r, :, :len(s)].T,
                                          ls[r, :, :len(s)].T), 1)
                          for r, s in enumerate(sat_idx)]).astype(np.int32)
    return offsets, matched, m_len.astype(np.uint8), sat


@pytest.mark.parametrize("N", [4096, 8192])
@pytest.mark.parametrize("vn", [False, True])
def test_match_rows_equals_jax_then_take_sat_cols(N, vn, nat):
    """Windows with saturated runs, an all-saturated zero row, almost
    nothing in random bytes, and none at all (n_real 3 and 0)."""
    rows = window_rows(N, seed=N + vn + 100)
    ours = grouped_inputs(rows, N, vn, nat.match_group)
    want = _jax_rows(grouped_inputs(rows, N, vn, jax_native.match_group), vn)
    got = MF.match_rows(**{k: torch.from_numpy(v) for k, v in ours.items()},
                        vn=vn)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    counts = np.diff(got[0].numpy(), axis=0)
    assert counts[4, 1] > N // 2 and (counts[5:] == 0).all()
    assert counts[0, 0] > 0 and counts[3].sum() < N // 100


def test_grouped_compact_validates_its_arguments(nat):
    a = {k: torch.from_numpy(v) for k, v in grouped_inputs(
        window_rows(4096, 1)[:2], 4096, False, nat.match_group).items()}
    with pytest.raises(TypeError, match="orders must be torch.int32"):
        MF.match_rows(**{**a, "orders": a["orders"].long()}, vn=False)
    with pytest.raises(ValueError, match=r"oks must be \(2, 4096\)"):
        MF.match_rows(**{**a, "oks": a["oks"][:, :100].contiguous()}, vn=False)
    with pytest.raises(ValueError, match="pads must be contiguous"):
        MF.match_rows(**{**a, "pads": a["pads"].t().contiguous().t()},
                      vn=False)


@pytest.mark.parametrize("vn", [False, True])
def test_windows_compact_grouped_equals_tpu_encoder(vn, enc):
    """Several windows with history context over one source, as the JAX
    package's own test of its grouped path builds them."""
    rng = np.random.default_rng(41)
    data = words(rng, 2500)
    full = np.frombuffer(data, np.uint8)
    wins = []
    for start in range(0, len(data), 2048):
        base, ctx = max(start - 1024, 0), min(start, 1024)
        n = min(len(data), start + 2048 + 3) - base
        wins.append((0, base, ctx, n, 8192))
    want = TpuEncoder()._windows_compact_grouped({0: full}, wins, vn)
    got = enc._windows_compact_grouped({0: full}, wins, vn)
    assert got.keys() == want.keys() and len(got) == len(wins)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vn", [False, True])
def test_device_matches_equal_spec_and_tpu_encoder(vn, enc):
    rng = np.random.default_rng(33)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 7), dtype=np.uint8))
             for _ in range(16)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 16, 700))
    got = enc._device_matches(data, vn=vn)
    for want in (find_matches(data, vn=vn),
                 TpuEncoder()._device_matches(data, vn=vn)):
        for field in ("pos", "match_pos", "fwd_len", "back_max"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
    assert len(got.pos) > 100


@pytest.fixture(scope="module")
def mixed():
    rng = np.random.default_rng(23)
    pat = rng.integers(0, 256, 13, np.uint8).tobytes()
    return [b"", words(rng, 500)[:3000],            # empty, LZVN-sized
            corpus.make_raw("text", 30_000, rng),
            bytes(rng.integers(0, 256, 20_000, dtype=np.uint8)),
            (pat * (45_000 // 13 + 1))[:45_000]]    # period-split eligible


def test_encode_many_equals_native_and_tpu_encoder(mixed, enc, nat,
                                                   interpret):
    ref = TpuEncoder(device_emission=True, frontend="device")
    want = ref.encode_many(mixed)
    assert ref.last_emission == "device"
    stats: dict = {}
    got = enc.encode_many(mixed, stats)
    assert enc.last_emission == "device"
    assert got == want
    assert got == [nat.encode_bytes(s) for s in mixed]
    assert DEVICE_STAGES <= set(stats) and "frontend" not in stats
    det = stats["detail_match"]
    wins = enc.windows(mixed)
    assert sorted(d["N"] for d in det) == sorted({w[4] for w in wins})
    assert sum(d["windows"] for d in det) == len(wins) == 3
    # up: 6 bytes a slot; down: only the compacted rows and the offsets
    assert all(d["upload_bytes"] >= 6 * d["slots"]
               and d["download_bytes"] == 8 * (d["windows"] + 1)
               + 9 * d["matched"] + 36 * d["sat"] for d in det)


def test_encode_bytes_equals_native_and_tpu_encoder(mixed, enc, nat,
                                                    interpret):
    ref = TpuEncoder(device_emission=True, frontend="device")
    for src in mixed:
        got = enc.encode_bytes(src)
        assert got == nat.encode_bytes(src)
        assert got == ref.encode_bytes(src)


def test_two_window_input_equals_native(enc, nat):
    """One source of two windows: the second carries WINDOW_CTX bytes of
    history, and saturated rows re-extend across the window end."""
    rng = np.random.default_rng(29)
    src = corpus.make_raw("text", M.WINDOW_STRIDE + 100_000, rng)
    assert len(src) > M.WINDOW_STRIDE == 786_301
    wins = enc.windows([src])
    assert [w[2] for w in wins] == [0, M.WINDOW_CTX]
    assert enc.encode_bytes(src) == nat.encode_bytes(src)


def test_match_args_are_what_the_path_passes(enc, nat):
    rng = np.random.default_rng(3)
    sources = [corpus.make_raw("html", 20_000, rng), b"tiny",
               corpus.make_raw("urls", 9_000, rng)]
    wins = enc.windows(sources)
    assert [(w[0], w[4]) for w in wins] == [(0, 32768), (2, 16384)]
    args = enc.match_args(sources, wins)
    assert [a["pads"].shape for a in args] == [(1, 16384), (1, 32768)]
    a = args[1]
    n = len(sources[0])
    assert a["pads"][0, :n].numpy().tobytes() == sources[0]
    assert not a["pads"][0, n:].any()
    order, ok = nat.match_group(a["pads"][0].numpy(), n, False)
    np.testing.assert_array_equal(a["orders"][0].numpy(), order)
    np.testing.assert_array_equal(a["oks"][0].numpy(), ok)
    assert (int(a["n_reals"][0]), int(a["los"][0]),
            int(a["his"][0])) == (n, 0, M.WINDOW_STRIDE)


def test_kernel_failure_propagates(mixed, enc, monkeypatch):
    """A failing match finder raises out of both entry points; nothing
    falls back to the native frontend or a host encoder."""
    def boom(*a, **kw):
        raise RuntimeError("match_rows failed")

    monkeypatch.setattr(MF, "match_rows", boom)
    with pytest.raises(RuntimeError, match="match_rows failed"):
        enc.encode_many(mixed)
    with pytest.raises(RuntimeError, match="match_rows failed"):
        enc.encode_bytes(mixed[2])


@pytest.mark.parametrize("frontend", ["argsort", "", None, "Device"])
def test_unknown_frontend_raises(frontend):
    with pytest.raises(ValueError, match="frontend must be one of"):
        TorchEncoder("cpu", frontend=frontend)


def test_default_frontend_is_native():
    assert TorchEncoder("cpu").frontend == "native"


def _edge_windows(seed: int):
    """Windows over one source with history context, as the JAX package's
    test of its two branches builds them, plus a window of another size
    on a second source."""
    rng = np.random.default_rng(seed)
    data = words(rng, 2500)
    wins = []
    for start in range(0, len(data), 2048):
        base, ctx = max(start - 1024, 0), min(start, 1024)
        n = min(len(data), start + 2048 + 3) - base
        wins.append((0, base, ctx, n, 8192))
    other = corpus.make_raw("html", 3_000, rng) * 3
    wins.append((1, 0, 0, len(other), 16384))
    return {0: np.frombuffer(data, np.uint8),
            1: np.frombuffer(other, np.uint8)}, wins


@pytest.mark.parametrize("vn", [False, True])
def test_argsort_windows_equal_tpu_encoder(vn, enc, monkeypatch):
    """``LZT_DEV_GROUPED=0``: ``_windows_compact`` (the argsort branch,
    ``find_matches_compact`` as torch ops) == ``TpuEncoder._windows_compact``
    under the same setting, window by window, and == the grouped path."""
    fulls, wins = _edge_windows(43)
    grouped = enc._windows_compact(fulls, wins, vn)
    monkeypatch.setenv("LZT_DEV_GROUPED", "0")
    want = TpuEncoder()._windows_compact(fulls, wins, vn)
    stats: dict = {}
    got = enc._windows_compact(fulls, wins, vn, stats)
    assert got.keys() == want.keys() == grouped.keys()
    assert len(got) == len(wins)
    for k in want:
        for g, w, h in zip(got[k], want[k], grouped[k]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, h)
    det = stats["detail_match"]
    assert [d["N"] for d in det] == [8192, 16384]
    assert {"win_prep", "matchfind", "arbitrate"} <= set(stats)
    assert all(d["download_bytes"] > 0 and d["upload_bytes"] == d["windows"]
               * (d["N"] + 12) for d in det)


@pytest.mark.parametrize("setting", ["0", "", "2"])
def test_argsort_encode_equals_native(setting, mixed, enc, nat, monkeypatch):
    """Any value but "1" takes the argsort branch, as in the JAX encoder:
    the native encoder's containers from ``encode_many`` and
    ``encode_bytes``, and no launch of the grouped-match entry."""
    monkeypatch.setenv("LZT_DEV_GROUPED", setting)
    monkeypatch.setattr(MF, "match_rows", lambda *a, **k: pytest.fail(
        "the argsort branch called match_rows"))
    stats: dict = {}
    assert enc.encode_many(mixed, stats) == [nat.encode_bytes(s)
                                             for s in mixed]
    assert DEVICE_STAGES <= set(stats)
    assert enc.encode_bytes(mixed[2]) == nat.encode_bytes(mixed[2])


def test_argsort_two_window_input_equals_native(enc, nat, monkeypatch):
    monkeypatch.setenv("LZT_DEV_GROUPED", "0")
    rng = np.random.default_rng(31)
    src = corpus.make_raw("text", M.WINDOW_STRIDE + 30_000, rng)
    assert [w[2] for w in enc.windows([src])] == [0, M.WINDOW_CTX]
    assert enc.encode_many([src]) == [nat.encode_bytes(src)]
