"""The port's incremental stream decoders and its command-line tool against
the JAX package's.

* ``spec.streaming.SpecStreamDecoder`` (the port's copy) and the port's
  native ``StreamDecoder`` against the JAX package's ``SpecStreamDecoder``,
  pushed in chunks of several sizes, on seeded containers and on
  truncated, extended and bit-flipped copies: the same bytes, or an
  exception of the same class with the same message;
* a stream of several 512 KiB windows through the ring encoder, the
  one-shot decoder and the pull reader (``tests/test_streaming.py``);
* ``python -m lzfse_rust_tpu_torch.cli -encode`` piped into ``-decode``,
  two processes: SHA-exact, the stream equal to the JAX tool's, and the
  same exit code and message on a truncated stream.
"""

import hashlib
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import lzfse_rust_tpu_torch as P
from lzfse_rust_tpu.spec.streaming import SpecStreamDecoder as JaxSpec
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.spec.streaming import SpecStreamDecoder as PortSpec
from lzfse_rust_tpu_torch.utils import corpus

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHUNKS = [1, 7, 997, 1 << 16]


def gen_stream(n: int, seed: int = 9) -> bytes:
    """Deterministic compressible byte stream, as ``test_streaming.py``
    makes it."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(64)]
    out = bytearray()
    while len(out) < n:
        out += words[int(rng.integers(0, 64))]
        out += b" "
    return bytes(out[:n])


def _stream_decode(mk, src: bytes, chunk: int):
    """Push ``src`` in chunks of ``chunk`` bytes, pulling as it goes: the
    output, or the exception's class name and message."""
    try:
        dec = mk()
        out = bytearray()
        i = 0
        while i < len(src):
            i += dec.push(src[i:i + chunk])
            while True:
                got = dec.pull()
                if not got:
                    break
                out += got
        while True:
            got = dec.pull()
            if not got:
                break
            out += got
        dec.finish()
        return bytes(out)
    except Exception as exc:  # noqa: BLE001 - the exception is the result
        return (type(exc).__name__, str(exc))


@pytest.fixture(scope="module")
def sources():
    """Seeded containers of every block type, then truncated, extended
    and bit-flipped copies."""
    pairs = corpus.small_batch(seed=61, n_fse=3, lo=20_000, hi=70_000)
    good = [c for _, c in pairs]
    rng = np.random.default_rng(61)
    bad = []
    for c in good[:6]:
        bad.append(c[:int(rng.integers(0, len(c)))])
        bad.append(c + b"xyzw")
        b = bytearray(c)
        b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(8))
        bad.append(bytes(b))
    return {"good": good, "bad": bad}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["good", "bad"])
def test_spec_stream_decoder_equals_jax(kind, chunk, sources):
    for src in sources[kind]:
        want = _stream_decode(JaxSpec, src, chunk)
        assert _stream_decode(PortSpec, src, chunk) == want
        if kind == "good":
            assert want == P.decode_bytes(src)


@pytest.mark.parametrize("chunk", CHUNKS[1:])
def test_native_stream_decoder_equals_the_spec_decoder(chunk, sources):
    """The native engine gives the spec decoder's bytes on every valid
    container, and raises (its own message) wherever the spec decoder
    raises."""
    nat = native_runtime()
    for src in sources["good"] + sources["bad"]:
        want = _stream_decode(JaxSpec, src, chunk)
        got = _stream_decode(nat.StreamDecoder, src, chunk)
        if isinstance(want, tuple):
            assert isinstance(got, tuple), len(src)
        else:
            assert got == want


def test_multi_window_stream_roundtrip():
    data = gen_stream(3 * 0x80000 + 12345)
    sink = io.BytesIO()
    n_raw, n_payload = P.LzfseRingEncoder().encode(io.BytesIO(data), sink)
    assert n_raw == len(data)
    enc = sink.getvalue()
    assert len(enc) == n_payload
    assert P.decode_bytes(enc) == data
    r = P.LzfseRingDecoder().reader(io.BytesIO(enc))
    got = bytearray()
    while True:
        chunk = r.read(65537)
        if not chunk:
            break
        got += chunk
    assert bytes(got) == data
    assert _stream_decode(PortSpec, enc, 65537) == data


def _cli(*args, data: bytes):
    return subprocess.run([sys.executable, "-m", "lzfse_rust_tpu_torch.cli",
                           *args], input=data, capture_output=True,
                          cwd=ROOT, timeout=300)


def test_cli_two_process_pipe():
    """-encode piped into -decode through a real pipe between the two
    processes, as the reference's huge-stream test runs lzfoo."""
    data = gen_stream(1 << 20)
    cmd = [sys.executable, "-m", "lzfse_rust_tpu_torch.cli"]
    enc = subprocess.Popen(cmd + ["-encode"], stdin=subprocess.PIPE,
                           stdout=subprocess.PIPE, cwd=ROOT)
    dec = subprocess.Popen(cmd + ["-decode"], stdin=enc.stdout,
                           stdout=subprocess.PIPE, cwd=ROOT)
    enc.stdout.close()
    enc.stdin.write(data)
    enc.stdin.close()
    out = dec.stdout.read()
    assert enc.wait(timeout=300) == 0 and dec.wait(timeout=300) == 0
    assert hashlib.sha256(out).digest() == hashlib.sha256(data).digest()


def test_cli_stream_and_errors_equal_the_jax_tool(tmp_path):
    data = gen_stream(300_000, seed=4)
    ours = _cli("-encode", "-v", data=data)
    theirs = subprocess.run([sys.executable, str(ROOT / "lzfoo"), "-encode"],
                            input=data, capture_output=True, cwd=ROOT,
                            timeout=300)
    assert ours.returncode == theirs.returncode == 0
    assert ours.stdout == theirs.stdout
    assert ours.stderr.decode().startswith(
        f"encode: {len(data)} -> {len(ours.stdout)} bytes, ratio ")
    src, dst = tmp_path / "in.lzfse", tmp_path / "out.raw"
    src.write_bytes(ours.stdout)
    assert _cli("-decode", "-i", str(src), "-o", str(dst),
                data=b"").returncode == 0
    assert dst.read_bytes() == data
    bad = ours.stdout[:-9]
    got = _cli("-decode", data=bad)
    want = subprocess.run([sys.executable, str(ROOT / "lzfoo"), "-decode"],
                          input=bad, capture_output=True, cwd=ROOT,
                          timeout=300)
    assert got.returncode == want.returncode == 1
    assert got.stderr == want.stderr
    assert got.stderr.startswith(b"lzfoo: decode failed: ")
