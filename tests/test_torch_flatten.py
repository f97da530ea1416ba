"""The native rebuild's flatten in ``TorchDecoder`` as array operations.

``_flatten_plan`` turns the container walk's parts and each FSE block's
stream check into the native rebuild's inputs without a Python step a
container. ``_loop_flatten`` below is the per-container loop it replaced,
kept as the oracle: both must give the same parts, part and output
offsets, kept containers and failed containers, on batches with FSE, LZVN
and RAW parts, empty containers, walk-rejected containers, failing stream
checks and no FSE block at all. Then ``decode_many`` on batches with two
failing containers must call the spec layer in the order the loop did
(stream-check failures first, then rebuild failures, each in container
order), so the same exception is raised and the same fallbacks counted.
"""

import numpy as np
import pytest

from lzfse_rust_tpu_torch import TorchDecoder
from lzfse_rust_tpu_torch.models import decoder as D
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.spec import container as spec_container
from lzfse_rust_tpu_torch.utils import corpus, timing

from torch_kit import bytes_addr


def _loop_flatten(parts, cpo, cont_nraw, cont_ok, fse_ok, row_off, lit_off):
    """The per-container flatten loop ``_flatten_plan`` replaced, with the
    spec-layer calls recorded in ``failed`` instead of made."""
    failed, keep_parts, cont_ids, out_offs = [], [], [], [0]
    for ci in np.flatnonzero(cont_ok):
        ci = int(ci)
        sub = parts[cpo[ci]:cpo[ci + 1]]
        k0 = sub[sub[:, 0] == 0, 1]
        if len(k0) and not fse_ok[k0].all():
            failed.append(ci)
            continue
        keep_parts.append(sub)
        cont_ids.append(ci)
        out_offs.append(out_offs[-1] + int(cont_nraw[ci]))
    parts_np = (np.ascontiguousarray(np.concatenate(keep_parts))
                if keep_parts else np.zeros((0, 6), np.int32))
    if len(parts_np):
        k0 = parts_np[:, 0] == 0
        if k0.any():
            g = parts_np[k0, 1]
            parts_np[k0, 1] = row_off[g]
            parts_np[k0, 4] = lit_off[g]
    cont_off_np = np.zeros(len(cont_ids) + 1, np.int32)
    if keep_parts:
        cont_off_np[1:] = np.cumsum([len(p) for p in keep_parts])
    return (cont_ids, failed, parts_np, cont_off_np,
            np.asarray(out_offs, np.int64))


def _joined(*containers: bytes) -> bytes:
    """One container holding the blocks of each, in turn."""
    return b"".join(c[:-4] for c in containers) + corpus.EMPTY


@pytest.fixture(scope="module")
def kinds():
    """Containers by block kind: FSE (one and several blocks), LZVN, RAW,
    empty, a container of all three kinds, and walk-rejected ones."""
    rng = np.random.default_rng(7)
    enc = corpus.encode
    fse = [enc(corpus.make_raw(k, int(rng.integers(3_000, 12_000)), rng))
           for k in ("text", "html", "binary")]
    big = enc(corpus.make_raw("text", 300_000, rng))
    vn = enc(corpus.make_raw("text", 1_500, rng))
    raw = enc(corpus.make_raw("random", 2_000, rng))
    assert [c[:4] for c in (fse[0], vn, raw)] == [b"bvx2", b"bvxn", b"bvx-"]
    return dict(fse=fse, big=big, vn=vn, raw=raw, empty=enc(b""),
                bare=corpus.EMPTY, mixed=_joined(fse[1], vn, raw, fse[2]),
                rejected=[fse[0][:len(fse[0]) // 2], b"bvxZ" + fse[1][4:],
                          b""])


BATCHES = {
    "mixed": lambda k: [*k["fse"], k["vn"], k["empty"], k["raw"], k["big"],
                        k["bare"], k["mixed"]],
    "walk_rejected": lambda k: [k["rejected"][0], k["fse"][0], k["vn"],
                                k["rejected"][1], k["mixed"],
                                k["rejected"][2]],
    "all_rejected": lambda k: list(k["rejected"]),
    "no_fse": lambda k: [k["vn"], k["raw"], k["empty"], k["bare"], k["vn"]],
    "empty_only": lambda k: [k["bare"], k["empty"]],
    "none": lambda k: [],
}

# which FSE blocks fail their stream check, by block index
CHECKS = {
    "all_pass": lambda nb, rng: np.ones(nb, bool),
    "first_fails": lambda nb, rng: np.arange(nb) != 0,
    "last_fails": lambda nb, rng: np.arange(nb) != nb - 1,
    "random": lambda nb, rng: rng.random(nb) < 0.6,
    "all_fail": lambda nb, rng: np.zeros(nb, bool),
}


@pytest.mark.parametrize("check", list(CHECKS))
@pytest.mark.parametrize("name", list(BATCHES))
def test_flatten_plan_equals_the_loop(name, check, kinds):
    sources = BATCHES[name](kinds)
    desc, _, parts, cpo, cont_nraw, cont_ok = native_runtime().walk_batch(
        sources)
    nb = len(desc)
    rng = np.random.default_rng(len(sources) * 31 + nb)
    fse_ok = CHECKS[check](nb, rng)
    # the blocks' offsets in the FSE stage's outputs: any values, so each
    # is told apart
    row_off = rng.integers(0, 1 << 20, nb).astype(np.int64)
    lit_off = rng.integers(0, 1 << 22, nb).astype(np.int64)
    parts_before = parts.copy()
    want = _loop_flatten(parts, cpo, cont_nraw, cont_ok, fse_ok, row_off,
                         lit_off)
    kept, failed, parts_np, cont_off, out_offs = D._flatten_plan(
        parts, cpo, cont_nraw, cont_ok, fse_ok, row_off, lit_off)
    assert kept.tolist() == want[0]
    assert failed.tolist() == want[1]
    for got, exp in zip((parts_np, cont_off, out_offs), want[2:]):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        np.testing.assert_array_equal(got, exp)
    assert parts_np.flags.c_contiguous
    np.testing.assert_array_equal(parts, parts_before)   # the walk's parts
    if name == "mixed":
        assert {0, 2, 3} <= set(parts[:, 0].tolist())
        assert (np.diff(cpo) == 0).any()   # an empty container
    if name in ("walk_rejected", "all_rejected"):
        assert not cont_ok.all()
    if name in ("no_fse", "empty_only", "none", "all_rejected"):
        assert nb == 0


def test_new_outputs_gives_each_buffer_address():
    sizes = np.array([0, 1, 7, 4096, 300_000], np.int64)
    out, ptrs = native_runtime().new_outputs(sizes)
    assert [len(b) for b in out] == sizes.tolist()
    assert ptrs.dtype == np.int64
    assert ptrs.tolist() == [bytes_addr(b) for b in out]


@pytest.mark.parametrize("sizes", [[0, 1, 7, 4095, 4096, 300_000, 2, 9000],
                                   [1, 1, 300, 4095], [4096, 70_000], []])
def test_new_outputs_small_and_large_alone_and_mixed(sizes):
    """Outputs below and from 4 KiB, each kind alone and mixed: fresh
    bytes objects of the sizes asked for, in order, each its own (the
    empty one aside), at the addresses given."""
    sizes = np.array(sizes, np.int64)
    out, ptrs = native_runtime().new_outputs(sizes)
    assert [len(b) for b in out] == sizes.tolist()
    assert all(type(b) is bytes for b in out)
    assert len({id(b) for b in out if b}) == np.count_nonzero(sizes)
    assert ptrs.tolist() == [bytes_addr(b) for b in out]


def test_src_ptrs_point_at_each_source():
    """``native.src_ptrs`` holds each source's buffer address and length,
    through which the source's bytes read back, for an empty batch too;
    anything that is not a bytes object raises TypeError."""
    import ctypes
    nat = native_runtime()
    srcs = [b"", b"a", b"bvx-" + bytes(50), corpus.EMPTY, bytes(9000)]
    addrs, lens = nat.src_ptrs(srcs)
    assert addrs.tolist() == [bytes_addr(b) for b in srcs]
    assert lens.tolist() == [len(b) for b in srcs]
    assert [ctypes.string_at(a, n) for a, n in zip(addrs.tolist(),
                                                   lens.tolist())] == srcs
    assert [len(x) for x in nat.src_ptrs([])] == [0, 0]
    for bad in ([b"ab", bytearray(b"cd")], [b"ab", memoryview(b"cd")],
                [None], ["text"]):
        with pytest.raises(TypeError, match="takes bytes objects"):
            nat.src_ptrs(bad)


def _flipped(c: bytes, stage: str, dec: TorchDecoder) -> bytes:
    """A copy of ``c`` with one byte flipped that the walk accepts, the
    spec layer rejects, and the decoder sends to the spec layer at
    ``stage``: ``"flatten"`` (an FSE block fails its stream check) or
    ``"rebuild"`` (the native rebuild's status is wrong). Tries at most
    40 flips that the spec layer rejects."""
    tries = 0
    for at in range(len(c) - 5, 28, -1):
        for bit in (0, 3, 6):
            b = bytearray(c)
            b[at] ^= 1 << bit
            b = bytes(b)
            try:
                spec_container.decode_bytes(b)
                continue
            except Exception:  # noqa: BLE001 - any spec-layer error
                pass
            if not native_runtime().walk_batch([b])[5][0]:
                continue
            tries += 1
            if tries > 40:
                raise AssertionError(f"no flip of the container fails at "
                                     f"{stage}")
            calls = []
            real = D._spec

            def spy(sources, ci, stats):
                calls.append(stage_of[0])
                return b""

            stage_of = [None]
            mark = timing._Clock.mark

            def marked(self, key):
                stage_of[0] = key
                return mark(self, key)

            D._spec, timing._Clock.mark = spy, marked
            try:
                dec.decode_many([b])
            finally:
                D._spec, timing._Clock.mark = real, mark
            # the stage last closed before the spec call: "device" for a
            # call during the flatten, "flatten" for one during the rebuild
            if calls == [{"flatten": "device", "rebuild": "flatten"}[stage]]:
                return b
    raise AssertionError(f"no flip of the container fails at {stage}")


def _outcome(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the exception is the result
        return (type(exc).__name__, str(exc))


@pytest.fixture(scope="module")
def failing(kinds):
    """Containers that fail at the rebuild (an LZVN payload) and at the
    stream checks (an FSE payload), with the good ones around them."""
    dec = TorchDecoder("cpu")
    return dict(dec=dec, rebuild=_flipped(kinds["vn"], "rebuild", dec),
                flatten=_flipped(kinds["fse"][0], "flatten", dec),
                good=[kinds["fse"][1], kinds["raw"], kinds["mixed"]])


@pytest.mark.parametrize("layout", ["rebuild_first", "flatten_first",
                                    "apart"])
def test_spec_layer_order_is_the_loops(layout, failing):
    """Stream-check failures go to the spec layer first, in container
    order, then rebuild failures: the first exception raised is the one the
    per-container loop raised, whatever the failing containers' places."""
    rb, fl, good = failing["rebuild"], failing["flatten"], failing["good"]
    sources = {"rebuild_first": [rb, fl, *good],
               "flatten_first": [fl, rb, *good],
               "apart": [good[0], rb, good[1], fl, good[2]]}[layout]
    want = _outcome(lambda: spec_container.decode_bytes(fl))
    other = _outcome(lambda: spec_container.decode_bytes(rb))
    assert isinstance(want, tuple) and isinstance(other, tuple)
    assert want != other   # so the order shows in what is raised
    stats: dict = {}
    got = _outcome(lambda: failing["dec"].decode_many(sources, stats))
    assert got == want
    assert stats["fallbacks"] == 1   # the rebuild failure was not reached


def test_spec_layer_calls_and_fallbacks(failing, monkeypatch):
    """With the spec layer answering, every failing container is sent to it
    once, in the loop's order, the good ones decode, and the fallbacks
    count each failure."""
    rb, fl, good = failing["rebuild"], failing["flatten"], failing["good"]
    sources = [good[0], rb, fl, good[1], rb, fl, good[2]]
    calls = []

    def spy(srcs, ci, stats):
        calls.append(ci)
        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
        return b"spec%d" % ci

    monkeypatch.setattr(D, "_spec", spy)
    stats: dict = {}
    got = failing["dec"].decode_many(sources, stats)
    assert calls == [2, 5, 1, 4]
    assert stats["fallbacks"] == 4
    want = [spec_container.decode_bytes(c) for c in good]
    assert got == [want[0], b"spec1", b"spec2", want[1], b"spec4", b"spec5",
                   want[2]]
