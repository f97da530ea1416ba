"""The decoder's per-container work on Python objects, in C.

``native.src_ptrs`` (each source's buffer address and length) and
``native.new_outputs`` (a list of fresh bytes objects and their buffers'
addresses) run one C loop each (``runtime/src/pyobjects.c``, loaded with
``ctypes.PyDLL``). ``_py_src_ptrs`` and ``_py_new_outputs`` below are the
Python passes they replaced, kept as the oracles: the arrays and objects
must be the same, errors the same, and no reference or memory may leak.
Then ``TorchDecoder`` on the ETC-shaped batch of
``tests/test_torch_small_objects.py`` walks once and decodes every value,
and several decoders on more threads than cores, with a short switch
interval, each decode their own batch exactly.
"""

import ctypes
import gc
import os
import sys
import threading
import tracemalloc
from itertools import repeat

import numpy as np
import pytest

from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
from lzfse_rust_tpu_torch import api as P
from lzfse_rust_tpu_torch.models import decoder as D
from lzfse_rust_tpu_torch.runtime import build, native
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.utils import corpus

from test_torch_small_objects import KINDS, make_batch, quantile_sizes
from torch_kit import bytes_addr


def _bytes_data_offset() -> int:
    probe = b"offset probe"
    return ctypes.cast(ctypes.c_char_p(probe), ctypes.c_void_p).value - \
        id(probe)


BYTES_DATA = _bytes_data_offset()
_PyBytes_New = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_char_p,
                                 ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))


def _py_src_ptrs(sources):
    """The Python pass ``native.src_ptrs`` replaced: addresses from ``id``
    plus the bytes header, then the lengths."""
    for t in set(map(type, sources)):
        if not issubclass(t, bytes):
            raise TypeError(f"src_ptrs takes bytes objects, not {t.__name__}")
    n = len(sources)
    return (np.fromiter(map(id, sources), np.int64, n) + BYTES_DATA,
            np.fromiter(map(len, sources), np.int64, n))


def _py_new_outputs(sizes):
    """The Python pass ``native.new_outputs`` replaced: ``bytes(n)`` below
    4 KiB, the uninitialized ctypes allocation from there."""
    small = sizes < 4096
    big = np.flatnonzero(~small)
    out = list(map(bytes, np.where(small, sizes, 0).tolist()))
    D._put(out, big, map(_PyBytes_New, repeat(None, len(big)),
                         sizes[big].tolist()))
    return out, np.fromiter(map(id, out), np.int64, len(out)) + BYTES_DATA


class _Bytes(bytes):
    pass


SOURCES = {"empty_batch": [], "empty": [b""], "one_byte": [b"a"],
           "9kb": [bytes(range(256)) * 36],
           "subclass": [_Bytes(b"bvx-sub"), b"x"],
           "mixed": [b"", b"a", _Bytes(b"sub" * 300), bytes(9000), b"bvx$"]}


@pytest.fixture(scope="module")
def nat():
    return native_runtime()


@pytest.mark.parametrize("name", SOURCES)
def test_source_spans_equal_the_python_pass(name, nat):
    srcs = SOURCES[name]
    addrs, lens = nat.src_ptrs(srcs)
    want_a, want_l = _py_src_ptrs(srcs)
    assert addrs.dtype == lens.dtype == np.int64
    np.testing.assert_array_equal(addrs, want_a)
    np.testing.assert_array_equal(lens, want_l)
    assert [ctypes.string_at(a, n) for a, n in zip(addrs.tolist(),
                                                   lens.tolist())] == srcs


@pytest.mark.parametrize("bad", [bytearray(b"cd"), memoryview(b"cd"), "text",
                                 None], ids=lambda b: type(b).__name__)
def test_source_spans_raise_as_the_python_pass(bad, nat):
    for srcs in ([bad], [b"ab", bad], [bad, b"ab"]):
        with pytest.raises(TypeError) as want:
            _py_src_ptrs(srcs)
        with pytest.raises(TypeError) as got:
            nat.src_ptrs(srcs)
        assert str(got.value) == str(want.value)


def test_source_spans_take_a_tuple(nat):
    srcs = (b"ab", b"", bytes(5000))
    addrs, lens = nat.src_ptrs(srcs)
    np.testing.assert_array_equal(addrs, _py_src_ptrs(srcs)[0])
    assert lens.tolist() == [2, 0, 5000]


SIZES = [0, 1, 511, 512, 4095, 4096, 8192, 1 << 20]


@pytest.mark.parametrize("sizes", [SIZES, SIZES[::-1], [0, 0, 1, 1], []],
                         ids=["rising", "falling", "tiny", "none"])
def test_outputs_are_fresh_bytes_at_the_addresses_given(sizes, nat):
    sizes = np.array(sizes, np.int64)
    out, addrs = nat.new_outputs(sizes)
    want, _ = _py_new_outputs(sizes)
    assert type(out) is list
    assert [len(b) for b in out] == [len(b) for b in want] == sizes.tolist()
    assert all(type(b) is bytes for b in out)
    assert len({id(b) for b in out if b}) == np.count_nonzero(sizes)
    assert addrs.dtype == np.int64
    assert addrs.tolist() == [bytes_addr(b) for b in out]
    assert [sys.getrefcount(b) for b in out] == \
        [sys.getrefcount(b) for b in want]
    # each buffer is the object's own: writing through the address
    # changes that object alone
    for k, (b, a) in enumerate(zip(out, addrs.tolist())):
        if len(b):
            ctypes.memset(a, k + 1, len(b))
    assert [set(b) for b in out] == [{k + 1} if len(b) else set()
                                     for k, b in enumerate(out)]


def test_outputs_hold_no_other_reference(nat):
    """The list is held by its name alone, each object by the list."""
    sizes = np.array([100, 5000], np.int64)
    out, _ = nat.new_outputs(sizes)
    want, _ = _py_new_outputs(sizes)
    assert sys.getrefcount(out) == sys.getrefcount(want) == 2
    assert [sys.getrefcount(out[k]) for k in (0, 1)] == \
        [sys.getrefcount(want[k]) for k in (0, 1)] == [2, 2]


@pytest.mark.parametrize("last, error", [(-1, SystemError),
                                         (1 << 50, MemoryError)])
def test_a_failed_allocation_raises_and_frees_the_rest(last, error, nat):
    """A size that cannot be allocated raises, and the objects made before
    it go with the list."""
    sizes = np.array([1000] * 1000 + [last, 7], np.int64)
    nat.new_outputs(sizes[:3])
    gc.collect()
    tracemalloc.start()
    try:
        n0 = len(gc.get_objects())
        m0, _ = tracemalloc.get_traced_memory()
        for _ in range(3):
            with pytest.raises(error):
                nat.new_outputs(sizes)
        gc.collect()
        n1 = len(gc.get_objects())
        m1, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert n1 - n0 <= 4
    assert m1 - m0 < 64 << 10   # 1 MB a call if the objects leaked


def test_no_reference_or_memory_leaks_over_calls(nat):
    srcs = [bytes(k) for k in range(0, 600, 3)]
    sizes = np.array(SIZES * 8, np.int64)

    def once():
        nat.src_ptrs(srcs)
        out, addrs = nat.new_outputs(sizes)
        del out, addrs

    for _ in range(20):
        once()
    gc.collect()
    tracemalloc.start()
    try:
        n0 = len(gc.get_objects())
        m0, _ = tracemalloc.get_traced_memory()
        for _ in range(200):
            once()
        gc.collect()
        n1 = len(gc.get_objects())
        m1, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert n1 - n0 <= 4
    # 200 calls allocate 200 x 9.2 MB; what stays is bookkeeping
    assert m1 - m0 < 64 << 10


def test_only_the_decoder_needs_the_object_helpers(monkeypatch):
    """``libpyobjects.so`` is built at the first ``src_ptrs`` or
    ``new_outputs`` call, not by ``native_runtime``: where it cannot be
    built (no ``Python.h``), encoding works and a decoder is made, and its
    first decode raises ``BuildError``."""
    def fail():
        raise build.BuildError("Python.h not found")

    native_runtime()
    monkeypatch.setattr(native, "_OBJ", None)
    monkeypatch.setattr(build, "build_objects", fail)
    raw = b"abcd" * 3000
    cont = native_runtime().encode_bytes(raw)
    assert P.decode_bytes(P.encode_bytes(raw)) == raw
    assert TorchEncoder("cpu").encode_many([raw, b""]) == \
        [cont, native_runtime().encode_bytes(b"")]
    dec = TorchDecoder("cpu")
    for call in (lambda: dec.decode_many([cont]),
                 lambda: native.new_outputs(np.array([5], np.int64))):
        with pytest.raises(build.BuildError, match="Python.h not found"):
            call()
    assert native._OBJ is None
    monkeypatch.undo()
    assert dec.decode_many([cont]) == [raw]


@pytest.fixture(scope="module")
def etc():
    sizes = quantile_sizes(1024)
    kinds = [KINDS[i % 4] for i in range(1024)]
    return make_batch(sizes, kinds)


def test_etc_batch_walks_once_and_decodes(etc):
    """1,024 ETC-shaped values: one part a container, as many as the walk's
    smallest first capacity holds, and the first try fits them, in every
    call."""
    raws, conts = etc
    dec = TorchDecoder("cpu")
    for _ in range(2):
        stats: dict = {}
        assert dec.decode_many(conts, stats) == raws
        assert stats["walks"] == 1
        assert stats.get("fallbacks", 0) == 0
        parts = stats["detail_parts"]
        assert parts["fse_blocks"] + parts["vn_blocks"] + \
            parts["raw_blocks"] == len(conts) == 1024
        assert parts["fse_blocks"] >= 2


def test_walk_counts_its_tries(etc, nat):
    """Each three ETC values joined into one container of their blocks:
    342 containers, 1,024 parts, and 1,040 with one more container of six
    values. The first try holds 1,024 parts at least, a part a container
    and the caller's last walk, and a try that the batch outgrows is
    walked again at 4x; every walk equals ``walk_batch``'s."""
    _, conts = etc
    conts = [b"".join(c[:-4] for c in conts[i:i + 3]) + b"bvx$"
             for i in range(0, len(conts), 3)]
    more = conts + [b"".join(c[:-4] for c in etc[1][:6]) + b"bvx$"]
    for batch, n_parts, cases in (
            (conts, 1024, (((0, 0), 1), ((1, 1), 1), ((3, 4096), 1))),
            (more, 1030, (((0, 0), 2), ((1, 1), 2), ((0, 1030), 1),
                          ((3, 4096), 1)))):
        ptrs = nat.src_ptrs(batch)
        want = nat.walk_batch(batch)
        assert len(want[2]) == n_parts
        for last, tries in cases:
            got, n = nat.walk(ptrs, last)
            assert n == tries, (n_parts, last)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _mixed_batch(seed: int, fse: bool):
    """(raws, containers): LZVN and RAW containers and empty ones, and
    with ``fse`` an FSE container."""
    pairs = [p for p in corpus.small_batch(seed=seed, n_fse=1, lo=5_000,
                                           hi=6_000)
             if fse or p[1][:4] != b"bvx2"]
    rng = np.random.default_rng(seed)
    extra = [b"abc" * 3, corpus.make_raw("text", 900, rng),
             bytes(range(256)) * 2]
    enc = native_runtime().encode_bytes
    return ([r for r, _ in pairs] + extra,
            [c for _, c in pairs] + [enc(r) for r in extra])


def test_decoders_on_many_threads_each_decode_their_batch():
    """More threads than cores, each with its own decoder and batch, while
    the interpreter switches threads every 10 us: every fourth thread
    decodes a batch with an FSE container once (the kernels' plain
    versions hand the lock over at every torch operation), the others a
    batch of LZVN and RAW containers 20 times. Every output equals its raw
    input."""
    n_threads = min(os.cpu_count() or 1, 8) + 4
    batches = [_mixed_batch(100 + k, k % 4 == 0) for k in range(n_threads)]
    kinds = {c[:4] for _, conts in batches for c in conts}
    assert kinds == {b"bvx2", b"bvxn", b"bvx-", b"bvx$"}
    decs = [TorchDecoder("cpu") for _ in range(n_threads)]
    results: dict = {}

    def run(k):
        raws, conts = batches[k]
        results[k] = all(decs[k].decode_many(conts) == raws
                         for _ in range(1 if k % 4 == 0 else 20))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == dict.fromkeys(range(n_threads), True)
