"""The port's public API (``lzfse_rust_tpu_torch.api``) against the JAX
package's (``lzfse_rust_tpu.api``).

Both run on the host, each on its own native runtime. The inputs are made
from seeds with numpy; every comparison is exact:

* the encode x decode matrix of ``tests/test_api_matrix.py`` (one-shot,
  engine object, ring IO, push writer x one-shot, engine object, ring IO,
  pull reader) at sizes 0, 1, 21, 4,000 and 300,000: each encoder's
  container equals the JAX package's, byte for byte, and every decoder
  gives the input back;
* ``encode_many`` / ``decode_many`` and ``probe`` on a seeded corpus
  batch, through both routes of the batch entry points: ``device="cpu"``
  (the host thread pool) and the card route, here with ``TorchDecoder`` /
  ``TorchEncoder`` on the CPU (their plain versions), on a card as it
  is (marked ``cuda``); malformed batches raise the JAX API's error;
* the writer and the reader with fuzzed chunk boundaries;
* truncated, trailing and garbage input: the same exception class and
  message through every decode entry point;
* ``_SpecStreamEncoder`` (the spec-layer stream encoder);
* the one deliberate difference: ``_native()`` raises when the runtime
  cannot be built, where the JAX package quietly takes the spec route.
"""

import functools
import io
import threading

import numpy as np
import pytest
import torch

import lzfse_rust_tpu as J
import lzfse_rust_tpu_torch as P
from lzfse_rust_tpu import api as jax_api
from lzfse_rust_tpu_torch import api as port_api
from lzfse_rust_tpu_torch.runtime import build
from lzfse_rust_tpu_torch.utils import corpus

SIZES = [0, 1, 21, 4000, 300_000]


def _data(size: int) -> bytes:
    """The matrix's input of ``size`` bytes, as ``test_api_matrix.py``
    makes it."""
    rng = np.random.default_rng(size + 1)
    words = [bytes(rng.integers(97, 123, 7, dtype=np.uint8))
             for _ in range(32)]
    return b"".join(words[int(i)] for i in
                    rng.integers(0, 32, max(size // 7 + 1, 1)))[:size]


def _encoders(lz):
    def one_shot(data):
        return lz.encode_bytes(data)

    def engine(data):
        return lz.LzfseEncoder().encode_bytes(data)

    def ring_io(data):
        sink = io.BytesIO()
        lz.LzfseRingEncoder().encode(io.BytesIO(data), sink)
        return sink.getvalue()

    def writer(data):
        w = lz.LzfseWriterBytes()
        for i in range(0, max(len(data), 1), 10_007):
            w.write(data[i:i + 10_007])
        return w.into_bytes()

    return {"one_shot": one_shot, "engine": engine, "ring_io": ring_io,
            "writer": writer}


def _decoders(lz):
    def one_shot(enc):
        return lz.decode_bytes(enc)

    def engine(enc):
        return lz.LzfseDecoder().decode_bytes(enc)

    def ring_io(enc):
        sink = io.BytesIO()
        lz.LzfseRingDecoder().decode(io.BytesIO(enc), sink)
        return sink.getvalue()

    def reader(enc):
        r = lz.LzfseRingDecoder().reader_bytes(enc)
        out = bytearray()
        while True:
            chunk = r.read(8191)
            if not chunk:
                break
            out += chunk
        return bytes(out)

    return {"one_shot": one_shot, "engine": engine, "ring_io": ring_io,
            "reader": reader}


ENCODERS = list(_encoders(P))


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("size", SIZES)
def test_encode_decode_matrix_equals_jax(size, encoder):
    data = _data(size)
    got = _encoders(P)[encoder](data)
    assert got == _encoders(J)[encoder](data)
    for name, dec in _decoders(P).items():
        assert dec(got) == data, f"{encoder} x {name} ({size}B)"


def test_ring_byte_accounting_equals_jax():
    """(n_raw, n_payload) from the ring encoder, (n_payload, n_raw) from
    the ring decoder, on a stream of several IO chunks."""
    data = _data(300_000)
    out = {}
    for lz in (J, P):
        sink = io.BytesIO()
        enc = lz.LzfseRingEncoder().encode(io.BytesIO(data), sink)
        dec = lz.LzfseRingDecoder().decode(io.BytesIO(sink.getvalue()),
                                           io.BytesIO())
        out[lz] = (enc, dec, sink.getvalue())
    assert out[P] == out[J]
    enc, dec, blob = out[P]
    assert enc == (len(data), len(blob)) and dec == (len(blob), len(data))


@pytest.fixture(scope="module")
def pairs():
    return corpus.small_batch(seed=51, n_fse=5, lo=5_000, hi=80_000)


@pytest.fixture(params=["cpu", "engines"])
def route(request, monkeypatch):
    """The ``device`` that takes each route of the batch entry points on the
    CPU: ``"cpu"``, the host thread pool; ``"engines"``, the card route
    with the batch engines on the CPU (their plain versions) in place of
    the card's."""
    if request.param == "cpu":
        return "cpu"

    @functools.cache
    def card(kind, device):
        assert device.type == "cuda"
        engine = P.TorchDecoder if kind == "decode" else P.TorchEncoder
        return engine("cpu"), threading.Lock()

    monkeypatch.setattr(port_api, "_card", card)
    return "cuda"


def test_encode_many_decode_many_equal_jax(pairs, route):
    raws = [r for r, _ in pairs]
    blobs = P.encode_many(raws, device=route)
    assert blobs == J.encode_many(raws)
    assert blobs == [P.encode_bytes(r) for r in raws]
    assert P.decode_many(blobs, device=route) == raws == J.decode_many(blobs)
    assert P.encode_many(raws[:1], device=route) == J.encode_many(raws[:1])
    assert P.decode_many([], device=route) == []
    assert P.encode_many([], device=route) == []


def test_corpus_containers_are_the_api_encoders(pairs, route):
    sources = [c for r, c in pairs if c != corpus.EMPTY]
    assert P.encode_many([r for r, c in pairs if c != corpus.EMPTY],
                         device=route) == sources


def test_probe_equals_jax(pairs):
    for raw, c in pairs:
        assert P.probe(c) == J.probe(c) == (len(c), len(raw))


@pytest.mark.parametrize("seed", [17, 18])
def test_writer_and_reader_fuzzed_boundaries_equal_jax(seed):
    """Random-length write() and read() chunking, as
    ``tests/test_streaming.py`` fuzzes them: the written streams equal the
    JAX writer's and read back whole."""
    data = corpus.make_raw("text", 300_000, np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    cuts = np.cumsum(rng.integers(1, 50_000, 40))
    pieces = np.split(np.frombuffer(data, np.uint8), cuts[cuts < len(data)])
    streams = {}
    for lz in (J, P):
        sink = io.BytesIO()
        w = lz.LzfseWriter(sink)
        for piece in pieces:
            w.write(piece.tobytes())
        w.close()
        streams[lz] = sink.getvalue()
    assert streams[P] == streams[J]
    reads = np.random.default_rng(seed + 100).integers(1, 70_000, 400)
    r = P.LzfseRingDecoder().reader(io.BytesIO(streams[P]))
    got = bytearray()
    for n in reads:
        chunk = r.read(int(n))
        if not chunk:
            break
        got += chunk
    assert bytes(got) == data
    assert r.read(10) == b""


def test_reader_readinto_and_read_all():
    data = _data(300_000)
    blob = P.encode_bytes(data)
    r = P.LzfseRingDecoder().reader_bytes(blob)
    buf = bytearray(1000)
    assert r.readinto(buf) == 1000 and bytes(buf) == data[:1000]
    assert r.read() == data[1000:]


def _outcome(fn):
    """fn()'s result, or the raised exception's class name and message."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the exception is the result
        return (type(exc).__name__, str(exc))


def _bad_inputs():
    good = P.encode_bytes(_data(300_000))
    rng = np.random.default_rng(5)
    return {"truncated": good[:len(good) - 7], "trailing": good + b"xyzw",
            "garbage": bytes(rng.integers(0, 256, 5_000, dtype=np.uint8)),
            "bad_magic": b"bvxZ" + good[4:], "empty": b"",
            "eos_cut": good[:-2]}


@pytest.mark.parametrize("decoder", ["one_shot", "engine", "ring_io",
                                     "reader"])
@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_errors_equal_jax(case, decoder):
    """The same exception class and message as the JAX package."""
    src = _bad_inputs()[case]
    want = _outcome(lambda: _decoders(J)[decoder](src))
    got = _outcome(lambda: _decoders(P)[decoder](src))
    assert isinstance(want, tuple), want
    assert got == want


BUFFERS = {"memoryview": memoryview, "bytearray": bytearray}


@pytest.mark.parametrize("case", list(_bad_inputs()) + list(BUFFERS))
def test_batch_errors_equal_jax(case, route):
    """A bad container between good ones (or a good one in a ``memoryview``
    or a ``bytearray``): the JAX API's exception class and message,
    whichever route the batch takes."""
    good = [P.encode_bytes(_data(n)) for n in (4000, 300_000)]
    bad = (BUFFERS[case](good[1]) if case in BUFFERS
           else _bad_inputs()[case])
    batch = [good[0], bad, good[1]]
    want = _outcome(lambda: J.decode_many(batch))
    assert isinstance(want, tuple), want
    assert _outcome(lambda: P.decode_many(batch, device=route)) == want


@pytest.mark.parametrize("size", [4000, 300_000])
@pytest.mark.parametrize("buffer", list(BUFFERS))
def test_buffer_batches_raise_as_jax(buffer, size, route):
    """A batch of ``memoryview`` or ``bytearray`` objects, to decode and to
    encode: the JAX API's exception class and message on both routes (the
    card's parse takes bytes only, so the card route raises the host
    route's error)."""
    raw = _data(size)
    for call, item in (("decode_many", P.encode_bytes(raw)),
                       ("encode_many", raw)):
        for n in (1, 2):
            batch = [BUFFERS[buffer](item)] * n
            want = _outcome(lambda: getattr(J, call)(batch))
            assert isinstance(want, tuple), want
            got = _outcome(lambda: getattr(P, call)(batch, device=route))
            assert got == want, (call, n)


@pytest.mark.parametrize("route", ["engines"], indirect=True)
def test_card_route_does_not_fall_back(route, monkeypatch):
    """An error the card raises on a batch the host decodes is raised as
    it is: the card route never returns the host's output."""
    blobs = [P.encode_bytes(_data(4000))] * 2
    dec, _ = port_api._card("decode", torch.device("cuda"))

    def fail(sources):
        raise P.BadBlock(7)

    monkeypatch.setattr(dec, "decode_many", fail)
    with pytest.raises(P.BadBlock, match="0x00000007"):
        P.decode_many(blobs)


def test_batch_device_must_be_cuda_or_cpu():
    for call in (P.decode_many, P.encode_many):
        with pytest.raises(ValueError, match="unsupported device"):
            call([b"abc"], device="meta")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_batch_default_device_is_the_card():
    """Without a card the default ``device="cuda"`` raises, as every entry
    point of the port does; nothing quietly takes the host."""
    for call in (P.decode_many, P.encode_many):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call([P.encode_bytes(b"abc" * 100)])


@pytest.mark.cuda
def test_cuda_batch_route_equals_jax(pairs):
    """On a card the default route launches the batch engines' kernels and
    gives the JAX API's containers, bytes and errors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lzfse_rust_tpu_torch.ops import cuda_decode, cuda_encode
    raws = [r for r, _ in pairs]
    before = {**cuda_decode.launches, **cuda_encode.launches}
    blobs = P.encode_many(raws)
    assert blobs == J.encode_many(raws)
    assert P.decode_many(blobs) == raws == J.decode_many(blobs)
    after = {**cuda_decode.launches, **cuda_encode.launches}
    assert all(after[k] > before[k] for k in ("decode_literals",
                                              "decode_lmds",
                                              "encode_literals",
                                              "encode_lmds"))
    for bad in _bad_inputs().values():
        batch = [blobs[0], bad, blobs[-1]]
        want = _outcome(lambda: J.decode_many(batch))
        assert _outcome(lambda: P.decode_many(batch)) == want


def test_errors_are_the_ports_classes():
    with pytest.raises(P.LzfseError) as info:
        P.decode_bytes(b"bvx2" + b"\x00" * 40)
    assert type(info.value).__module__ == "lzfse_rust_tpu_torch.base.errors"
    assert not isinstance(info.value, J.LzfseError)


@pytest.mark.parametrize("size", [0, 100, 0x80000, 0x80000 * 2 + 12_345])
def test_spec_stream_encoder_equals_jax(size):
    data = corpus.make_raw("html", size, np.random.default_rng(size))
    outs = []
    for mod in (jax_api, port_api):
        enc = mod._SpecStreamEncoder()
        out = bytearray()
        for i in range(0, len(data), 100_000):
            enc.push(data[i:i + 100_000])
            out += enc.pull(50_000)
        enc.finish()
        enc.finish()
        out += enc.pull()
        outs.append(bytes(out))
    assert outs[1] == outs[0]
    assert P.decode_bytes(outs[1]) == data


def test_chunk_constants_equal_jax():
    assert port_api.STREAM_CHUNK == jax_api.STREAM_CHUNK == 0x80000
    assert port_api._IO_CHUNK == jax_api._IO_CHUNK == 1 << 16


def test_version_equals_jax():
    assert P.__version__ == J.__version__ == "0.1.0"


def test_all_exports_the_jax_names_and_the_models():
    assert set(J.__all__) <= set(P.__all__)
    assert set(P.__all__) - set(J.__all__) == {"TorchDecoder", "TorchEncoder"}
    for name in P.__all__:
        assert getattr(P, name) is not None
    assert P.api.LzfseWriterBytes.__mro__[1] is P.LzfseWriter


def test_a_runtime_that_does_not_build_raises(monkeypatch):
    """Unlike the JAX package, which takes the spec route when its runtime
    is missing, the port's API raises ``BuildError``."""
    def fail():
        raise build.BuildError("g++ not found")

    monkeypatch.setattr(build, "build_native", fail)
    port_api._native.cache_clear()
    try:
        for call in (lambda: P.encode_bytes(b"abc"),
                     lambda: P.decode_bytes(b"bvx$"),
                     lambda: P.LzfseRingDecoder().reader_bytes(b"bvx$")):
            with pytest.raises(build.BuildError, match="g.. not found"):
                call()
    finally:
        monkeypatch.undo()
        port_api._native.cache_clear()
    assert P.decode_bytes(b"bvx$") == b""
