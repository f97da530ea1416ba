"""The port's multi-device layer (``parallel/mesh.py``) and the sorted match
finder against the JAX package's, on the CPU.

JAX runs on its virtual CPU devices (``tests/conftest.py`` forces eight),
the port on ``make_mesh(["cpu"] * n)``, one CPU standing in for several.
Inputs are made in the repository: ``tests/kit.py`` word streams encoded by
the JAX package's encoder, each package parsing the containers with its own
``_parse_container``; match-finder windows from ``tests/torch_kit.py``.
Every output is an integer or a byte, so every comparison is exact
(tolerance 0). The JAX kernels run in interpret mode through a patched
``pl.pallas_call``, as ``tests/test_parallel.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import kit
import lzfse_rust_tpu.models.decoder as JM
from lzfse_rust_tpu import api
from lzfse_rust_tpu.ops import match_find_tpu as JMF
from lzfse_rust_tpu.parallel import mesh as JP
from lzfse_rust_tpu.runtime import native as jax_native
from lzfse_rust_tpu_torch.base import constants as C
from lzfse_rust_tpu_torch.models import decoder as PM
from lzfse_rust_tpu_torch.ops import cuda_decode as K
from lzfse_rust_tpu_torch.ops import match_find as MF
from lzfse_rust_tpu_torch.parallel import mesh as PP
from lzfse_rust_tpu_torch.parallel.dryrun import example_arrays, kernel_arrays
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from torch_kit import grouped_inputs, window_rows

N_DEV = 4


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs JAX's virtual CPU devices (tests/conftest.py)")
    return JP.make_mesh(jax.devices()[:N_DEV]), PP.make_mesh(["cpu"] * N_DEV)


def _containers():
    """Four word streams of 5,000 to 9,500 bytes, each one FSE block."""
    return [api.encode_bytes(kit.WordSeq(seed=s).read(5_000 + 1_500 * s))
            for s in range(4)]


@pytest.fixture(scope="module")
def blocks():
    """Eight rows (each container twice), parsed by each package."""
    cs = _containers() * 2
    theirs, ours = [], []
    for ci, c in enumerate(cs):
        JM._parse_container(c, ci, theirs)
        PM._parse_container(c, ci, ours)
    assert len(theirs) == len(ours) == len(cs)
    return theirs, ours


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _steps(blocks):
    return (max((d.block.literal.num + 3) // 4 for d in blocks),
            max(d.block.lmd.num for d in blocks))


@pytest.fixture(scope="module")
def entropy(meshes, blocks):
    """Both packages' ``sharded_entropy_decode`` on the eight rows."""
    jm, pm = meshes
    n_lit, n_lmd = _steps(blocks[0])
    want = JP.sharded_entropy_decode(jm, example_arrays(blocks[0]), n_lit,
                                     n_lmd)
    got = PP.sharded_entropy_decode(pm, example_arrays(blocks[1]), n_lit,
                                    n_lmd)
    return got, [np.asarray(w) for w in want]


def test_sharded_entropy_decode_equals_jax(entropy):
    got, want = entropy
    _same(got, want)
    assert want[2].all()


def test_sharded_rebuild_equals_jax(meshes, entropy):
    jm, pm = meshes
    literals, lmds, _ = entropy[1]
    raws = [kit.WordSeq(seed=s).read(5_000 + 1_500 * s) for s in range(4)] * 2
    n_raw = np.array([len(r) for r in raws], np.int32)
    want = JP.sharded_rebuild(jm, literals, lmds, n_raw, 12_288)
    got = PP.sharded_rebuild(pm, literals, lmds, n_raw, 12_288)
    _same(got, want)
    out = got[0].numpy()
    assert [out[b, :n].tobytes() for b, n in enumerate(n_raw)] == raws
    assert got[1].all()


def test_gather_compressed_equals_jax(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 256, (8, 40), dtype=np.uint8)
    lens = rng.integers(0, 40, 8).astype(np.int32)
    want = JP.gather_compressed(jm, jnp.asarray(blocks), jnp.asarray(lens))
    _same(PP.gather_compressed(pm, blocks, lens), want)
    # one tensor per device, in batch order
    shards = PP.shard_batch(pm)(blocks)
    _same(PP.gather_compressed(pm, shards, PP.shard_batch(pm)(lens)), want)


def _windows(N: int, seed: int):
    """Eight windows of torch_kit's edge rows (n_real below 4 included)
    plus a copy of the first: (pads, n_reals, los, his)."""
    rows = window_rows(N, seed)
    rows = rows + rows[:8 - len(rows)]
    pads = np.zeros((8, N), np.uint8)
    for r, (data, *_ ) in enumerate(rows):
        pads[r, :len(data)] = np.frombuffer(data, np.uint8)
    cols = np.array([r[1:] for r in rows], np.int32).T
    return pads, cols[0], cols[1], cols[2]


@pytest.mark.parametrize("vn", [False, True])
def test_sharded_match_find_equals_jax(vn, meshes):
    jm, pm = meshes
    pads, n_reals, _, _ = _windows(4096, seed=11 + vn)
    want = JP.sharded_match_find(jm, pads, n_reals, vn)
    _same(PP.sharded_match_find(pm, pads, n_reals, vn), want)


def _distance_window(vn: bool):
    """One window of zeros holding three 24-byte random strings, each again
    at the largest distance - 1, the largest distance and one past it."""
    max_d = C.VN_MAX_D_VALUE if vn else C.MAX_D_VALUE
    N = -(-(max_d + 8192) // 8) * 8
    rng = np.random.default_rng(7 + vn)
    pad = np.zeros(N, np.uint8)
    for k, d in enumerate((max_d - 1, max_d, max_d + 1)):
        s = rng.integers(1, 256, 24, dtype=np.uint8)
        at = 1000 + 2000 * k
        pad[at:at + 24] = s
        pad[at + d:at + d + 24] = s
    return pad[None], np.array([N], np.int32), np.zeros(1, np.int32), \
        np.array([N], np.int32), max_d


@pytest.mark.parametrize("case", ["edges", "max_distance"])
@pytest.mark.parametrize("vn", [False, True])
def test_find_matches_equals_jax(case, vn):
    """``find_matches_device`` on each window and ``find_matches_compact``
    on the batch: n_real below 4, all-zero rows (every slot saturates),
    runs past 64 bytes, and candidates at the largest distance (taken) and
    one past it (not)."""
    if case == "edges":
        pads, n_reals, los, his = _windows(4096, seed=21 + vn)
    else:
        pads, n_reals, los, his, max_d = _distance_window(vn)
    want = JMF.find_matches_compact(*(jnp.asarray(a) for a in (
        pads, n_reals, los, his)), vn)
    got = MF.find_matches_compact(*(torch.from_numpy(a) for a in (
        pads, n_reals, los, his)), vn)
    _same(got, want)
    for b in range(len(pads)):
        one = MF.find_matches_device(torch.from_numpy(pads[b]),
                                     int(n_reals[b]), vn)
        _same(one, JMF.find_matches_device(jnp.asarray(pads[b]),
                                           jnp.int32(int(n_reals[b])), vn))
    counts = got[0].numpy()
    if case == "edges":
        assert (counts[4] > 0).all()            # the all-zero row saturates
        assert (counts[5:7] == 0).all()         # n_real 3 and 0
    else:
        dist = got[1].numpy()[:, None, :] - got[4].numpy()
        ok = got[4].numpy() >= 0
        assert (dist[ok] == max_d).any() and (dist[ok] == max_d - 1).any()
        assert not (dist[ok] > max_d).any()


@pytest.fixture
def interpret(monkeypatch):
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))


def test_sharded_pallas_entropy_decode_equals_unsharded_and_jax(
        blocks, interpret):
    """The decode kernels' plain versions over two CPU shards, against the
    unsharded port call and the JAX kernels under ``shard_map`` on two
    devices (interpret mode, 8 steps; each JAX shard is 128 rows)."""
    from lzfse_rust_tpu.ops.pallas_decode import R_ROWS
    steps = 8
    B = 2 * R_ROWS
    arrays = kernel_arrays(blocks[1][0], B, steps, steps)
    for k in ("lit_words", "lmd_words"):   # the JAX kernels read >= 256
        w = arrays[k]
        arrays[k] = np.pad(w, ((0, 0), (0, max(256 - w.shape[1], 0))))
    got = PP.sharded_pallas_entropy_decode(PP.make_mesh(["cpu"] * 2), arrays,
                                           steps, steps)
    one = PP.sharded_pallas_entropy_decode(PP.make_mesh(["cpu"]), arrays,
                                           steps, steps)
    lit = K.from_jax_decode_args(
        "literals", arrays["u3_tabs"], arrays["lit_words"],
        arrays["lit_states"], arrays["lit_pos"], arrays["lit_num"],
        arrays["lit_tot"])
    lmd = K.from_jax_decode_args(
        "lmds", arrays["v_tabs"], arrays["lmd_words"], arrays["lmd_states"],
        arrays["lmd_pos"], arrays["lmd_num"])
    w_lit, w_lmd = K.decode_literals(**lit), K.decode_lmds(**lmd)
    plain = (w_lit[0], w_lmd[0], w_lmd[1], w_lit[1], w_lit[2], w_lmd[2],
             w_lmd[3])
    for g, o, p in zip(got, one, plain, strict=True):
        assert torch.equal(g, o) and torch.equal(g, p)
    lits, lm, dd, lfs, lfp, mfs, mfp = JP.sharded_pallas_entropy_decode(
        JP.make_mesh(jax.devices()[:2]), arrays, steps, steps, epoch=steps)
    jl = K.from_jax_decode_outputs("literals", (lits, lfs, lfp),
                                   arrays["lit_num"])
    jm = K.from_jax_decode_outputs("lmds", (lm, dd, mfs, mfp),
                                   arrays["lmd_num"])
    _same(got, (jl[0], jm[0], jm[1], jl[1], jl[2], jm[2], jm[3]))


@pytest.mark.parametrize("vn", [False, True])
def test_sharded_grouped_match_equals_jax(vn, meshes):
    """The port returns what the JAX encoder read of JAX's
    ``sharded_grouped_match``: the key-1 slots' winners and, through
    ``take_sat_cols``, the key-0 slots' columns, window after window."""
    jm, pm = meshes
    rows = window_rows(4096, seed=31 + vn)
    rows = rows + rows[:8 - len(rows)]
    theirs = grouped_inputs(rows, 4096, vn, jax_native.match_group)
    ours = grouped_inputs(rows, 4096, vn, native_runtime().match_group)
    keys, bc, bl, cands, lcps = (np.asarray(x) for x in JP.sharded_grouped_match(
        jm, *(theirs[k] for k in ("pads", "n_reals", "los", "his", "orders",
                                  "oks")), vn))
    sat_idx = [np.flatnonzero(k == 0) for k in keys]
    idx = np.zeros((len(keys), max(map(len, sat_idx))), np.int32)
    for r, s in enumerate(sat_idx):
        idx[r, :len(s)] = s
    cs, ls = (np.asarray(x) for x in JMF.take_sat_cols(
        jnp.asarray(cands), jnp.asarray(lcps), jnp.asarray(idx)))
    w_wins, w_slots = np.nonzero(keys == 1)
    s_rows = [np.concatenate([s[:, None], cs[r, :, :len(s)].T,
                              ls[r, :, :len(s)].T], 1)
              for r, s in enumerate(sat_idx)]
    counts = np.stack([(keys == 1).sum(1), (keys == 0).sum(1)], 1)
    want = (np.concatenate([np.zeros((1, 2), np.int64),
                            np.cumsum(counts, 0)]).astype(np.int32),
            np.stack([w_slots, bc[w_wins, w_slots]], 1).astype(np.int32),
            bl[w_wins, w_slots].astype(np.uint8),
            np.concatenate(s_rows).astype(np.int32))
    got = PP.sharded_grouped_match(pm, **ours, vn=vn)
    _same(got, want)
    assert len(want[3]) and len(want[1])


@pytest.mark.parametrize("fn", [
    "shard_batch", "sharded_entropy_decode", "sharded_rebuild",
    "sharded_match_find", "sharded_pallas_entropy_decode",
    "sharded_grouped_match", "gather_compressed"])
def test_a_batch_the_mesh_does_not_divide_raises(fn, blocks):
    mesh = PP.make_mesh(["cpu"] * 3)
    d = blocks[1][0]
    calls = {
        "shard_batch": lambda: PP.shard_batch(mesh)(np.zeros((4, 2))),
        "sharded_entropy_decode": lambda: PP.sharded_entropy_decode(
            mesh, example_arrays([d] * 4), 8, 8),
        "sharded_rebuild": lambda: PP.sharded_rebuild(
            mesh, np.zeros((4, 8), np.uint8), np.zeros((4, 2, 3), np.int32),
            np.zeros(4, np.int32), 8),
        "sharded_match_find": lambda: PP.sharded_match_find(
            mesh, np.zeros((4, 64), np.uint8), np.zeros(4, np.int32)),
        "sharded_pallas_entropy_decode": lambda:
            PP.sharded_pallas_entropy_decode(mesh, kernel_arrays(d, 4, 8, 8),
                                             8, 8),
        "sharded_grouped_match": lambda: PP.sharded_grouped_match(
            mesh, **grouped_inputs(window_rows(512, 1)[:4], 512, False,
                                   native_runtime().match_group)),
        "gather_compressed": lambda: PP.gather_compressed(
            mesh, np.zeros((4, 8), np.uint8), np.zeros(4, np.int32)),
    }
    with pytest.raises(ValueError, match="does not divide into 3 equal"):
        calls[fn]()


def test_make_mesh_repeats_devices_and_checks_the_axis():
    mesh = PP.make_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="axis"):
        PP.shard_batch(mesh, axis="windows")(np.zeros(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.make_mesh()
