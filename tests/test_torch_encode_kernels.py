"""The port's tANS encode kernels and E-table build against the JAX reference.

``build_encode_tables`` must equal its JAX twin exactly.
``encode_literals_ref``/``encode_lmds_ref`` (the CUDA kernels' plain
versions, which the wrappers run on CPU tensors) must equal
``encode_literals_pallas``/``encode_lmds_pallas`` run in Pallas interpret
mode on every defined column (each row's first ``steps`` push groups) and
on the final states. One batch of 32 rows and 256 columns per kernel (one
interpret-mode compile each) holds cut-down blocks of seeded sources, an
empty row, counts that are not multiples of 4, exactly 128 and 129 steps
(the JAX kernels' superepoch edge), a full-width row, repeat distances and
the format's largest L, M and D values. Whole blocks, packed by
``native.pack_groups``, must give the spec encoder's payloads and params.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from lzfse_rust_tpu.base import constants as C
from lzfse_rust_tpu.ops import fse_encode as JF
from lzfse_rust_tpu.spec import fse as F
from lzfse_rust_tpu.spec import tables as T
from lzfse_rust_tpu_torch.ops import cuda_encode as K
from lzfse_rust_tpu_torch.ops.fse_encode import build_encode_tables
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.utils import corpus
from torch_kit import encode_blocks, encode_rows

B = 32
N_COLS = 256
CASES = ("empty", "corpus", "not_multiple_of_4", "steps_128", "steps_129",
         "full_width", "repeat_d", "largest_values")


def _uniform_weights() -> np.ndarray:
    """Every symbol of every class has a nonzero weight."""
    w = np.zeros(C.N_WEIGHTS, np.int64)
    w[:C.L_TOP] = [4] * 4 + [3] * 16
    w[C.L_TOP:C.M_TOP] = [3] * 16 + [4] * 4
    w[C.M_TOP:C.D_TOP] = 4
    w[C.D_TOP:C.U_TOP] = 4
    return w


def _block(rng, n_lit: int, n_lmd: int, values=None):
    """A synthetic block under the uniform weights: random literals and
    random valid L/M/D rows (``values`` appended at the end)."""
    lits = rng.integers(0, 256, n_lit).astype(np.uint8)
    rows = np.stack([rng.integers(0, C.MAX_L_VALUE + 1, n_lmd),
                     rng.integers(0, C.MAX_M_VALUE + 1, n_lmd),
                     rng.integers(0, C.MAX_D_VALUE + 1, n_lmd)],
                    1).astype(np.int32)
    if values is not None:
        rows[-len(values):] = values
    return lits, rows, 0, _uniform_weights()


def _cut(block, n_lit: int, n_lmd: int):
    """A corpus block cut to its first literals and rows (its weights still
    cover every symbol left)."""
    lits, rows, n_mb, w = block
    return lits[:n_lit], rows[:n_lmd], n_mb, w


@pytest.fixture(scope="module")
def batch():
    """The staged 32-row batch, which rows hold which case, and the JAX
    kernels' interpret-mode results on it."""
    rng = np.random.default_rng(5)
    raws = [corpus.make_raw(k, 6_000, rng) for k in ("text", "html", "binary")]
    real = encode_blocks(raws)
    assert len(real) == 3
    blocks, rows = [], {c: [] for c in CASES}

    def add(case, block):
        rows[case].append(len(blocks))
        blocks.append(block)

    add("empty", (np.zeros(0, np.uint8), np.zeros((0, 3), np.int32), 0,
                  real[0][3]))
    for i, blk in enumerate(real):
        add("corpus", _cut(blk, 300 + 250 * i, 40 + 60 * i))
    add("not_multiple_of_4", _cut(real[0], 5, 3))
    add("not_multiple_of_4", _cut(real[1], 203, 101))
    add("steps_128", _block(rng, 512, 128))
    add("steps_129", _block(rng, 516, 129))
    add("full_width", _block(rng, 4 * N_COLS, N_COLS))
    add("repeat_d", _block(rng, 64, 50, [[3, 4, 0], [0, 7, 0], [5, 300, 0]]))
    add("largest_values", _block(
        rng, 8, 40, [[C.MAX_L_VALUE, C.MAX_M_VALUE, C.MAX_D_VALUE],
                     [C.MAX_L_VALUE, 0, 1], [0, C.MAX_M_VALUE, 60],
                     [16, 16, C.MAX_D_VALUE], [60, 312, 16380]]))
    st = encode_rows(blocks, N_COLS, B)
    # raw literal counts: the padding is part of the kernel's input, the
    # count that is not a multiple of 4 is not
    for r in rows["not_multiple_of_4"]:
        st["lit_num"][r] = len(blocks[r][0])
    assert (st["lmd_num"][rows["repeat_d"]] > 0).all()

    mp = pytest.MonkeyPatch()
    real_call = pl.pallas_call
    mp.setattr(pl, "pallas_call",
               lambda *a, **k: real_call(*a, **{**k, "interpret": True}))
    try:
        from lzfse_rust_tpu.ops import pallas_encode as PE
        e_l, e_m, e_d, e_u = (np.asarray(x) for x in JF.build_encode_tables(
            jnp.asarray(st["weights"])))
        bcast = lambda x: np.repeat(x[:, None], 128, 1)  # noqa: E731
        lit_args = (e_u, st["words"], bcast(st["lit_num"]))
        lmd_args = (e_l, e_m, e_d, st["lm"], st["d"], bcast(st["lmd_num"]))
        lit_out = [np.asarray(x) for x in PE.encode_literals_pallas(
            *map(jnp.asarray, lit_args), N_COLS)]
        lmd_out = [np.asarray(x) for x in PE.encode_lmds_pallas(
            *map(jnp.asarray, lmd_args), N_COLS)]
    finally:
        mp.undo()
    return dict(st=st, rows=rows, lit_args=lit_args, lmd_args=lmd_args,
                lit_out=lit_out, lmd_out=lmd_out)


def _port(batch, kind):
    args = K.from_jax_encode_args(kind, *batch[f"{kind[:3]}_args"])
    fn = K.encode_literals if kind == "literals" else K.encode_lmds
    return K.defined_columns(kind, fn(**args), args["num"])


def _want(batch, kind):
    return K.from_jax_encode_outputs(kind, batch[f"{kind[:3]}_out"],
                                     batch[f"{kind[:3]}_args"][-1])


@pytest.mark.parametrize("kind", ["literals", "lmds"])
def test_plain_equals_pallas_interpret(batch, kind):
    for g, w, what in zip(_port(batch, kind), _want(batch, kind),
                          ("glo", "gmeta", "states")):
        assert g.shape == w.shape, what
        assert torch.equal(g, w), what


@pytest.mark.parametrize("case", CASES)
def test_case_rows_equal_pallas_interpret(batch, case):
    """Each case's rows, on their own: the steps they really ran and the
    Pallas kernels' results there."""
    r = batch["rows"][case]
    assert r
    st = batch["st"]
    steps = {"literals": K.steps_of("literals", st["lit_num"][r], N_COLS),
             "lmds": K.steps_of("lmds", st["lmd_num"][r], N_COLS)}
    want_steps = {"empty": (0, 0), "steps_128": (128, 128),
                  "steps_129": (129, 129),
                  "full_width": (N_COLS, N_COLS)}.get(case)
    if want_steps:
        assert (steps["literals"] == want_steps[0]).all()
        assert (steps["lmds"] == want_steps[1]).all()
    if case == "not_multiple_of_4":
        assert (st["lit_num"][r] % 4 != 0).all()
    for kind in ("literals", "lmds"):
        for g, w in zip(_port(batch, kind), _want(batch, kind)):
            assert torch.equal(g[r], w[r]), kind


def test_largest_values_reach_the_top_symbols(batch):
    """The largest-value rows really use L, M and D symbol 19, 19 and 63:
    their pairs carry 8, 11 and 15 extra bits."""
    r = batch["rows"]["largest_values"][0]
    n = int(batch["st"]["lmd_num"][r])
    lm = batch["st"]["lm"][r, N_COLS - n:]
    d = batch["st"]["d"][r, N_COLS - n:]
    assert (lm & 0xFFFF).max() == C.MAX_L_VALUE
    assert (lm >> 16).max() == C.MAX_M_VALUE
    assert d.max() == C.MAX_D_VALUE
    assert C.d_index(C.MAX_D_VALUE) <= 255
    assert C.D_BASE_FROM_VALUE[C.d_index(C.MAX_D_VALUE)] == 63


def test_empty_rows_keep_initial_states(batch):
    _, _, lfs = _port(batch, "literals")
    _, _, mfs = _port(batch, "lmds")
    empty = np.flatnonzero(batch["st"]["lit_num"] == 0)
    assert len(empty)
    assert (lfs[empty] == C.U_STATES).all()
    assert (mfs[empty] == torch.tensor([C.L_STATES, C.M_STATES,
                                        C.D_STATES], dtype=torch.int32)).all()


def test_tables_equal_jax():
    """E tables from seeded blocks' weights and from edge weights: all
    zero, and one symbol of each class holding the whole total."""
    rng = np.random.default_rng(3)
    raws = [corpus.make_raw(k, int(rng.integers(10_000, 60_000)), rng)
            for k in ("text", "urls", "html", "binary", "random")]
    w = [blk[3] for blk in encode_blocks(raws)]
    w.append(np.zeros(C.N_WEIGHTS, np.int64))
    for sym in (0, 7, 19):
        one = np.zeros(C.N_WEIGHTS, np.int64)
        one[sym] = C.L_STATES
        one[C.L_TOP + sym] = C.M_STATES
        one[C.M_TOP + 3 * sym] = C.D_STATES
        one[C.D_TOP + 13 * sym] = C.U_STATES
        w.append(one)
    w.append(_uniform_weights())
    weights = np.stack(w)
    want = [np.asarray(x) for x in JF.build_encode_tables(
        jnp.asarray(weights))]
    got = build_encode_tables(torch.from_numpy(weights))
    for g, x, name in zip(got, want, ("e_l", "e_m", "e_d", "e_u")):
        assert g.dtype == torch.int32 and g.is_contiguous()
        assert np.array_equal(g.numpy(), x), name
    got32 = build_encode_tables(torch.from_numpy(weights.astype(np.int32)))
    assert all(torch.equal(a, b) for a, b in zip(got, got32))


@pytest.mark.parametrize("seed", range(4))
def test_packed_groups_equal_spec_encoder(seed):
    """Whole blocks of seeded sources through the port's tables and plain
    versions, packed by ``native.pack_groups``: the spec encoder's payloads,
    bit offsets and final states."""
    rng = np.random.default_rng(40 + seed)
    raws = [corpus.make_raw(k, int(rng.integers(8_000, 30_000)), rng)
            for k in ("text", "html", "binary", "urls")]
    blocks = encode_blocks(raws)
    n_cols = 10112
    st = encode_rows(blocks, n_cols)
    e_l, e_m, e_d, e_u = build_encode_tables(torch.from_numpy(st["weights"]))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    glo, gmeta, lfs = (x.numpy() for x in K.encode_literals(
        e_u, t(st["words"]), t(st["lit_num"]),
        t(K.slot_order(K.steps_of("literals", st["lit_num"], n_cols)))))
    mlo, mmeta, mfs = (x.numpy() for x in K.encode_lmds(
        e_l, e_m, e_d, t(st["lm"]), t(st["d"]), t(st["lmd_num"]),
        t(K.slot_order(st["lmd_num"]))))
    nat = native_runtime()
    for i, (lits, rows3, _, w) in enumerate(blocks):
        etabs = T.EncoderTables(w)
        padded = np.concatenate([lits, np.full((-len(lits)) % 4, lits[0],
                                               np.uint8)])
        want_pay, want_param = F.encode_literals(padded, etabs)
        pay, off = nat.pack_groups(glo[i], gmeta[i], len(padded) // 4, 8)
        assert (pay, off) == (want_pay, want_param.bits)
        assert tuple(lfs[i] - C.U_STATES) == want_param.state
        want_pay_m, want_param_m = F.encode_lmds(rows3, etabs)
        pay_m, off_m = nat.pack_groups(mlo[i], mmeta[i], len(rows3), 22)
        assert (b"\x00" * 8 + pay_m, off_m) == (want_pay_m, want_param_m.bits)
        assert tuple(mfs[i] - [C.L_STATES, C.M_STATES, C.D_STATES]) == \
            want_param_m.state


def test_wrappers_reject_bad_arguments():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    good = dict(e_u=z(2, 256), words=z(2, 8), num=z(2), order=z(2))
    K.encode_literals(**good)
    with pytest.raises(TypeError):
        K.encode_literals(**{**good, "num": good["num"].long()})
    with pytest.raises(ValueError):
        K.encode_literals(**{**good, "e_u": z(2, 255)})
    with pytest.raises(ValueError):
        K.encode_literals(**{**good, "words": z(8, 2).t()})
    with pytest.raises(ValueError):
        K.encode_literals(**{**good, "words": z(16)})
    lmd = dict(e_l=z(2, 20), e_m=z(2, 20), e_d=z(2, 64), lm=z(2, 8),
               d=z(2, 8), num=z(2), order=z(2))
    K.encode_lmds(**lmd)
    with pytest.raises(ValueError):
        K.encode_lmds(**{**lmd, "d": z(2, 9)})
    with pytest.raises(ValueError):
        K.encode_lmds(**{**lmd, "order": z(3)})


def test_kernel_constants_match_format_tables():
    """The constants that ``csrc/fse_encode.cu`` writes out or computes
    equal the format's tables: its D symbol table, the L/M thresholds,
    extra bits and bases, and the D extra bits and bases."""
    src = (pathlib.Path(K.__file__).parents[1] / "csrc" /
           "fse_encode.cu").read_text()
    table = re.search(r"kDSymbol\[256\] = \{([^}]*)\}", src).group(1)
    assert [int(x) for x in table.replace(",", " ").split()] == \
        [int(x) for x in C.D_BASE_FROM_VALUE]
    for cls, t123, extra in (("L", (20, 28, 60), (2, 3, 5, 8)),
                             ("M", (24, 56, 312), (3, 5, 8, 11))):
        base = getattr(C, f"{cls}_BASE_VALUE")
        bits = getattr(C, f"{cls}_EXTRA_BITS")
        assert list(base[:16]) == list(range(16)) and not bits[:16].any()
        assert list(base[16:]) == [16, *t123] and tuple(bits[16:]) == extra
        sym = getattr(C, f"{cls}_BASE_FROM_VALUE")
        for v in range(len(sym)):
            assert sym[v] == (v if v < 16 else
                              16 + sum(v >= t for t in t123)), (cls, v)
    for j in range(64):
        assert C.D_EXTRA_BITS[j] == j >> 2
        assert C.D_BASE_VALUE[j] == ((4 + (j & 3)) << (j >> 2)) - 4
