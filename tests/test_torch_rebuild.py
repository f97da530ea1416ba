"""The LZ rebuild ports against the JAX package's ``ops/lz_rebuild.py``.

``substitute_distances``, ``lz_rebuild_batch`` (the padded layout) and
``lz_rebuild_flat`` (the flat layout, the CUDA kernel's plain version,
through ``from_jax_rebuild_args``) must equal the JAX functions exactly on
seeded inputs: ``ok`` on every container and the output bytes of every
container whose ``ok`` holds. The wrapper takes the plain version for CPU
tensors and checks its arguments.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzfse_rust_tpu.ops import lz_rebuild as J
from lzfse_rust_tpu_torch.ops import cuda_rebuild as CR
from lzfse_rust_tpu_torch.ops import lz_rebuild as LR
from torch_kit import REBUILD_CASES, rebuild_case


def _jax(lits, rows, n_raw, n_out):
    out, ok = J.lz_rebuild_batch(jnp.asarray(lits), jnp.asarray(rows),
                                 jnp.asarray(n_raw), n_out)
    return np.asarray(out), np.asarray(ok)


def _same(got, want):
    """ok on every container, output bytes where ok holds."""
    g_out, g_ok = (np.asarray(x) for x in got)
    w_out, w_ok = want
    assert g_ok.dtype == np.bool_ and np.array_equal(g_ok, w_ok)
    assert g_out.dtype == np.uint8
    g_out = g_out.reshape(w_out.shape)
    assert np.array_equal(g_out[w_ok], w_out[w_ok])


@pytest.mark.parametrize("case", ["leading_zeros", "all_zeros",
                                  "block_edges", "random"])
def test_substitute_distances_equals_jax(case):
    rng = np.random.default_rng(5)
    d = rng.integers(1, 5000, (6, 40)).astype(np.int32)
    d[rng.random(d.shape) < 0.5] = 0
    if case == "leading_zeros":
        d[:, :7] = 0
    elif case == "all_zeros":
        d[:] = 0
    elif case == "block_edges":
        # each row is a block: its first distance nonzero, its last zero,
        # and the next block must not see it
        d[:, 0] = np.arange(1, 7)
        d[:, -1] = 0
        d[1:, 0] = 0
    want = np.asarray(J.substitute_distances(jnp.asarray(d)))
    got = LR.substitute_distances(torch.from_numpy(d))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", REBUILD_CASES)
def test_lz_rebuild_batch_equals_jax(name):
    lits, rows, n_raw, n_out = rebuild_case(name, 7)
    want = _jax(lits, rows, n_raw, n_out)
    if name in ("bad_distance", "too_many_literals", "total_mismatch"):
        assert not want[1].all()
    assert want[1].any()
    got = LR.lz_rebuild_batch(torch.from_numpy(lits), torch.from_numpy(rows),
                              torch.from_numpy(n_raw), n_out)
    _same(got, want)


@pytest.mark.parametrize("name", REBUILD_CASES)
def test_lz_rebuild_flat_equals_jax(name):
    lits, rows, n_raw, n_out = rebuild_case(name, 8)
    want = _jax(lits, rows, n_raw, n_out)
    args = CR.from_jax_rebuild_args(lits, rows, n_raw, n_out)
    _same(LR.lz_rebuild_flat(**args), want)
    # through the wrapper: CPU tensors take the plain version, no launch
    before = CR.launches["lz_rebuild"]
    _same(CR.lz_rebuild(**args), want)
    assert CR.launches["lz_rebuild"] == before


def test_lz_rebuild_flat_ragged_equals_jax_per_container():
    """Containers of their own sizes end to end (empty ones too): each
    equals the JAX function run on that container alone, with its own L, R
    and n_out."""
    rng = np.random.default_rng(9)
    conts = []
    for b, name in enumerate(REBUILD_CASES * 2):
        lits, rows, n_raw, _ = rebuild_case(name, 20 + b, B=3, R=int(
            rng.integers(1, 30)), L=int(rng.integers(1, 80)))
        k = b % 3
        seg = max(int(n_raw[k]), 1) + int(rng.integers(0, 5))
        conts.append((lits[k], rows[k], n_raw[k:k + 1], seg))
    conts.append((np.zeros(0, np.uint8), np.zeros((0, 3), np.int32),
                   np.zeros(1, np.int32), 0))

    def off(x):
        return torch.from_numpy(np.concatenate(([0], np.cumsum(x)))
                                .astype(np.int32))

    args = dict(literals=torch.from_numpy(np.concatenate([c[0] for c in conts])),
                lit_off=off([len(c[0]) for c in conts]),
                rows=torch.from_numpy(np.concatenate([c[1] for c in conts])),
                row_off=off([len(c[1]) for c in conts]),
                n_raw=torch.from_numpy(np.concatenate([c[2] for c in conts])),
                out_off=off([c[3] for c in conts]))
    out, ok = LR.lz_rebuild_flat(**args)
    o = args["out_off"].numpy()
    n_ok = 0
    for k, (lits, rows, n_raw, seg) in enumerate(conts[:-1]):
        w_out, w_ok = _jax(lits[None], rows[None], n_raw, seg)
        assert bool(ok[k]) == bool(w_ok[0])
        if w_ok[0]:
            n_ok += 1
            assert out[o[k]:o[k + 1]].numpy().tobytes() == w_out[0].tobytes()
    assert bool(ok[-1]) and 0 < n_ok < len(conts) - 1


def test_lz_rebuild_overlap_semantics():
    """Self-extending overlapped matches (d < m) resolve like the
    byte-serial copy (lz/object.rs:60-74), as the JAX test checks."""
    lits = np.zeros((1, 8), np.uint8)
    lits[0, :3] = [7, 8, 9]
    rows = np.array([[[3, 0, 0], [0, 13, 2]]], np.int32)
    n_raw = np.array([16], np.int32)
    want = bytearray([7, 8, 9])
    for _ in range(13):
        want.append(want[-2])
    for out, ok in (LR.lz_rebuild_batch(torch.from_numpy(lits),
                                        torch.from_numpy(rows),
                                        torch.from_numpy(n_raw), 16),
                    CR.lz_rebuild(**CR.from_jax_rebuild_args(lits, rows,
                                                             n_raw, 16))):
        assert bool(ok[0])
        assert out.reshape(-1).tolist() == list(want)


def test_lz_rebuild_rejects_bad_distance():
    lits = np.zeros((1, 8), np.uint8)
    rows = np.array([[[2, 5, 3]]], np.int32)  # d = 3 > the 2 bytes made
    n_raw = np.array([7], np.int32)
    assert not bool(LR.lz_rebuild_batch(
        torch.from_numpy(lits), torch.from_numpy(rows),
        torch.from_numpy(n_raw), 8)[1][0])
    assert not bool(CR.lz_rebuild(**CR.from_jax_rebuild_args(
        lits, rows, n_raw, 8))[1][0])


def test_wrapper_checks_its_arguments():
    lits, rows, n_raw, n_out = rebuild_case("overlap", 3, B=2)
    args = CR.from_jax_rebuild_args(lits, rows, n_raw, n_out)
    with pytest.raises(TypeError, match="rows"):
        CR.lz_rebuild(**{**args, "rows": args["rows"].long()})
    with pytest.raises(TypeError, match="literals"):
        CR.lz_rebuild(**{**args, "literals": args["literals"].int()})
    with pytest.raises(ValueError, match="out_off"):
        CR.lz_rebuild(**{**args, "out_off": args["out_off"][:-1]})
    with pytest.raises(ValueError, match="contiguous"):
        CR.lz_rebuild(**{**args, "rows": args["rows"].t().contiguous().t()})
    with pytest.raises(ValueError, match="2\\*\\*31"):
        CR.lz_rebuild(**{**args, "n_out": 2**31})
    # an empty batch: nothing to rebuild, nothing launched
    empty = {k: v[:1] if k.endswith("_off") else v[:0]
             for k, v in args.items() if k != "n_out"}
    out, ok = CR.lz_rebuild(**empty)
    assert out.numel() == 0 and ok.numel() == 0


def _padded(conts, L: int, n_out: int):
    """The JAX padded layout of containers given as (literal bytes, rows
    [(l, m, d), ...], n_raw)."""
    R = max(len(c[1]) for c in conts)
    lits = np.zeros((len(conts), L), np.uint8)
    rows = np.zeros((len(conts), R, 3), np.int32)
    for b, (lit, rw, _) in enumerate(conts):
        lits[b, :len(lit)] = np.frombuffer(lit, np.uint8)
        rows[b, :len(rw)] = rw
    return lits, rows, np.array([c[2] for c in conts], np.int32), n_out


def _fold_case(name: str):
    """Containers whose match rows exercise the kernel's folded links:
    d = 1, d = m - 1, d = m and d > m; a d = 1 row longer than a 4096-byte
    tile; d <= 0 and d > match_start (both fail ok)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    lit = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    if name == "long_row":
        return _padded([(lit[:3], [(3, 9000, 1)], 9003),
                        (lit[:40], [(40, 9500, 37), (0, 3000, 13)], 12540)],
                       64, 13000)
    conts = []
    for b in range(4):
        rows, made = [(8, 0, 0)], 8
        for _ in range(12):
            m = int(rng.integers(2, 90))
            d = {"d_1": 1, "d_m_minus_1": m - 1, "d_eq_m": m,
                 "d_gt_m": m + int(rng.integers(1, 20)),
                 "d_le_0": 1, "d_past_start": 1}[name]
            d = max(1, min(d, made))
            rows.append((int(rng.integers(0, 3)), m, d))
            made += rows[-1][0] + m
        if b == 1 and name == "d_le_0":
            rows[5] = (rows[5][0], rows[5][1], 0)
            rows[9] = (rows[9][0], rows[9][1], -4)
        if b == 2 and name == "d_past_start":
            rows[4] = (rows[4][0], rows[4][1], made + 50)
        conts.append((lit[:8 + sum(r[0] for r in rows[1:])], rows, made))
    return _padded(conts, 64, 2048)


@pytest.mark.parametrize("name", ["d_1", "d_m_minus_1", "d_eq_m", "d_gt_m",
                                  "long_row", "d_le_0", "d_past_start"])
def test_lz_rebuild_flat_fold_cases_equal_jax(name):
    lits, rows, n_raw, n_out = _fold_case(name)
    want = _jax(lits, rows, n_raw, n_out)
    assert want[1].all() == (name not in ("d_le_0", "d_past_start"))
    assert want[1].any()
    args = CR.from_jax_rebuild_args(lits, rows, n_raw, n_out)
    _same(LR.lz_rebuild_flat(**args), want)
    # through the wrapper: CPU tensors take the plain version
    _same(CR.lz_rebuild(**args), want)


def test_lz_rebuild_detail_counts_the_rounds():
    """``detail`` gets the positions still pointing at a parent, before the
    first round and after each: 13 links of a d = 2 run need 4 rounds."""
    lits = np.zeros((1, 8), np.uint8)
    lits[0, :3] = [7, 8, 9]
    rows = np.array([[[3, 0, 0], [0, 13, 2]]], np.int32)
    args = CR.from_jax_rebuild_args(lits, rows, np.array([16], np.int32), 16)
    detail: dict = {}
    out, ok = CR.lz_rebuild(**args, detail=detail)
    assert bool(ok[0]) and detail["unresolved"] == [13, 11, 7, 0]
    assert out.tolist() == [7, 8, 9] + [8, 9] * 6 + [8]
