"""The port stands alone: it imports nothing of the JAX package, builds only
sources inside itself, and its copies of the JAX package's host layers (the
spec layer, the error classes, the native runtime) behave as the originals.

The originals are imported here only as the reference the copies are held
against.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from kit import FAMILIES
from lzfse_rust_tpu.runtime import native as jax_native
from lzfse_rust_tpu.spec import container as jax_container
from lzfse_rust_tpu.spec import frontend as jax_frontend
from lzfse_rust_tpu.spec import match_find as jax_match_find
from lzfse_rust_tpu.spec import streaming as jax_streaming
from lzfse_rust_tpu_torch.runtime import build
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.spec import container as port_container
from lzfse_rust_tpu_torch.spec import frontend as port_frontend
from lzfse_rust_tpu_torch.spec import match_find as port_match_find
from lzfse_rust_tpu_torch.spec import streaming as port_streaming
from lzfse_rust_tpu_torch.utils import corpus

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "lzfse_rust_tpu_torch"
PORT_SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__") for p in PKG.rglob("*.py"))


def _outcome(fn):
    """fn()'s result, or the raised exception's class name and message."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the exception is the result
        return (type(exc).__name__, str(exc))


def test_cpu_decode_and_encode_load_nothing_of_the_jax_package(tmp_path):
    """Every module of the port and chip_smoke.py imported, then a CPU
    decode (with each ``use_kernels`` / ``use_native_rebuild`` choice, and
    on a mesh of three CPU shards) and encode (with each frontend, with
    ``LZT_ENC_CHUNKS`` 2 and ``LZT_DEV_GROUPED`` 0, and on the mesh) of a
    small seeded batch, and the public API (one-shot, ring and ``cli.main``
    both ways): no ``lzfse_rust_tpu`` module is loaded afterwards."""
    src, mid, out = (str(tmp_path / n) for n in ("raw", "lzfse", "out"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "import chip_smoke\n"
            "from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder\n"
            "from lzfse_rust_tpu_torch.utils import corpus\n"
            "pairs = corpus.small_batch(seed=7, n_fse=3, lo=5_000, "
            "hi=40_000)\n"
            "got = TorchDecoder('cpu').decode_many([c for _, c in pairs])\n"
            "assert got == [r for r, _ in pairs]\n"
            "for uk, nr in ((True, False), (False, True), (False, False)):\n"
            "    dec = TorchDecoder('cpu', use_kernels=uk,\n"
            "                       use_native_rebuild=nr)\n"
            "    got = dec.decode_many([c for _, c in pairs])\n"
            "    assert got == [r for r, _ in pairs], (uk, nr)\n"
            "raws = [r for r, c in pairs if c != corpus.EMPTY]\n"
            "want = [c for r, c in pairs if c != corpus.EMPTY]\n"
            "assert TorchEncoder('cpu').encode_many(raws) == want\n"
            "dev = TorchEncoder('cpu', frontend='device')\n"
            "assert dev.encode_many(raws) == want\n"
            "from lzfse_rust_tpu_torch.parallel.mesh import make_mesh\n"
            "mesh = make_mesh(['cpu'] * 3)\n"
            "got = TorchDecoder('cpu', mesh=mesh).decode_many(\n"
            "    [c for _, c in pairs])\n"
            "assert got == [r for r, _ in pairs]\n"
            "assert TorchEncoder('cpu', mesh=mesh).encode_many(raws) == want\n"
            "import io, os\n"
            "os.environ['LZT_ENC_CHUNKS'] = '2'\n"
            "assert TorchEncoder('cpu').encode_many(raws) == want\n"
            "os.environ['LZT_DEV_GROUPED'] = '0'\n"
            "assert dev.encode_many(raws) == want\n"
            "import lzfse_rust_tpu_torch as lz\n"
            "from lzfse_rust_tpu_torch import cli\n"
            "assert [lz.encode_bytes(r) for r in raws] == want\n"
            "assert [lz.decode_bytes(c) for c in want] == raws\n"
            "sink = io.BytesIO()\n"
            "lz.LzfseRingEncoder().encode(io.BytesIO(raws[0]), sink)\n"
            "assert lz.LzfseRingDecoder().reader_bytes(sink.getvalue())"
            ".read() == raws[0]\n"
            f"open({src!r}, 'wb').write(raws[0])\n"
            f"assert cli.main(['-encode', '-i', {src!r}, '-o', {mid!r}]) == 0\n"
            f"assert cli.main(['-decode', '-i', {mid!r}, '-o', {out!r}]) == 0\n"
            f"assert open({out!r}, 'rb').read() == raws[0]\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'lzfse_rust_tpu'\n"
            "             or m.startswith('lzfse_rust_tpu.'))\n"
            "assert not bad, bad\n"
            "print('standalone', len(pairs))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr
    assert "standalone" in r.stdout


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_names_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+lzfse_rust_tpu(\.|\s|$)",
                         text, re.M)
    assert not re.search(r"^\s*import\s+.*\blzfse_rust_tpu\b(?!_torch)",
                         text, re.M)


def test_build_names_no_path_of_the_jax_package():
    text = (PKG / "runtime" / "build.py").read_text()
    code = "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("#"))
    assert '"lzfse_rust_tpu"' not in code and "'lzfse_rust_tpu'" not in code
    assert not re.search(r"lzfse_rust_tpu/", code.split('"""', 2)[2])
    assert build.NATIVE_SRC == PKG / "runtime" / "src" / "tpulzfse.cpp"
    assert build.CSRC == PKG / "csrc"


def _code_lines(path: pathlib.Path) -> list[str]:
    """The source's lines without its // comment lines."""
    return [line for line in path.read_text().splitlines()
            if not line.lstrip().startswith("//")]


def test_native_source_is_a_copy():
    """The port's C++ runtime source is the JAX package's, line for line,
    apart from comments."""
    ours = PKG / "runtime" / "src" / "tpulzfse.cpp"
    theirs = ROOT / "lzfse_rust_tpu" / "runtime" / "src" / "tpulzfse.cpp"
    assert _code_lines(ours) == _code_lines(theirs)
    assert len(ours.read_text().splitlines()) == len(
        theirs.read_text().splitlines())


@pytest.fixture(scope="module")
def pairs():
    return corpus.small_batch(seed=41, n_fse=4, lo=3_000, hi=30_000)


def _garbled(pairs):
    """Truncated, extended and bit-flipped copies of the batch's
    containers, seeded."""
    rng = np.random.default_rng(41)
    out = []
    for _, c in pairs:
        if not c:
            continue
        out.append(c[:int(rng.integers(0, len(c)))])
        out.append(c + bytes(rng.integers(0, 256, 3, dtype=np.uint8)))
        for _ in range(3):
            b = bytearray(c)
            at = int(rng.integers(0, len(b)))
            b[at] ^= 1 << int(rng.integers(8))
            out.append(bytes(b))
    return out


@pytest.mark.parametrize("kind", ["corpus", "garbled"])
def test_spec_container_equals_the_original(kind, pairs):
    """The port's spec.container.decode_bytes gives the same bytes as the
    JAX package's, or raises an exception of the same class name with the
    same message."""
    sources = ([c for _, c in pairs] if kind == "corpus"
               else _garbled(pairs))
    assert sources
    raised = 0
    for src in sources:
        want = _outcome(lambda: jax_container.decode_bytes(src))
        got = _outcome(lambda: port_container.decode_bytes(src))
        assert got == want
        raised += isinstance(want, tuple)
    if kind == "corpus":
        assert raised == 0
    else:
        assert raised > 0


@pytest.mark.parametrize("case", ["empty", "bad_magic", "zero_header",
                                  "trailing", "truncated_eos"])
def test_spec_errors_keep_names_and_messages(case, pairs):
    good = next(c for _, c in pairs if c[:4] == b"bvx2")
    src = {"empty": b"", "bad_magic": b"bvxZ" + good[4:],
           "zero_header": b"bvx2" + b"\x00" * 40,
           "trailing": good + b"\x00\x01", "truncated_eos": good[:-2]}[case]
    want = _outcome(lambda: jax_container.decode_bytes(src))
    got = _outcome(lambda: port_container.decode_bytes(src))
    assert isinstance(want, tuple) and got == want


@pytest.fixture(scope="module")
def natives():
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not load here")
    return jax_native, native_runtime()


def test_native_walk_batch_equals_the_original(pairs, natives):
    theirs, ours = natives
    sources = [c for _, c in pairs] + _garbled(pairs)[:12]
    want = theirs.walk_batch(sources)
    got = ours.walk_batch(sources)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", corpus.KINDS)
def test_native_encode_bytes_equals_the_original(kind, natives):
    theirs, ours = natives
    assert ours is not theirs and ours._LIB is not theirs._LIB
    rng = np.random.default_rng(43)
    for size in (0, 100, 5_000, 70_000):
        raw = corpus.make_raw(kind, size, rng)
        assert ours.encode_bytes(raw) == theirs.encode_bytes(raw)


@pytest.fixture(scope="module")
def match_inputs():
    """Seeded sources for the match finder: words, a source with runs past
    64 bytes, random bytes and a 3-byte input."""
    rng = np.random.default_rng(47)
    vocab = [bytes(rng.integers(97, 110, int(rng.integers(2, 7)),
                                dtype=np.uint8)) for _ in range(24)]
    words = b" ".join(vocab[int(i)] for i in rng.integers(0, 24, 3000))
    block = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    return [words, block * 9 + words[:700], corpus.make_raw("html", 9_000, rng),
            bytes(rng.integers(0, 256, 5_000, dtype=np.uint8)), b"abc"]


@pytest.mark.parametrize("vn", [False, True])
def test_spec_find_matches_equals_the_original(vn, match_inputs):
    for src in match_inputs:
        got = port_match_find.find_matches(src, vn)
        want = jax_match_find.find_matches(src, vn)
        for field in ("pos", "match_pos", "fwd_len", "back_max"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_spec_lcp_extension_equals_the_original(direction, match_inputs):
    """``_lcp_forward`` / ``_lcp_backward`` on seeded position pairs, below
    and above the 64 rows where the chain rule takes over."""
    rng = np.random.default_rng(48)
    for src in match_inputs[:3]:
        full = np.frombuffer(src, np.uint8)
        n = len(full)
        for rows in (40, 900):
            a = rng.integers(1, n, rows)
            b = np.maximum(a - rng.integers(1, 600, rows), 0)
            if direction == "forward":
                start = np.zeros(rows, np.int64)
                cap = (n - a).astype(np.int64)
                args = (full, a, b, start, cap)
            else:
                args = (full, a, b, np.minimum(a, b).astype(np.int64))
            name = f"_lcp_{direction}"
            got = getattr(port_match_find, name)(*args)
            want = getattr(jax_match_find, name)(*args)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", [name for name, _ in FAMILIES])
def test_spec_frontend_equals_the_original(family):
    """The port's ``spec.frontend.encode_bytes`` (and its FSE, LZVN and RAW
    bodies) gives the original's bytes on the kit families."""
    gen = dict(FAMILIES)[family]
    for size in (0, 17, 3_000, 60_000):
        data = gen().read(size)
        got = port_frontend.encode_bytes(data)
        assert got == jax_frontend.encode_bytes(data)
        assert port_container.decode_bytes(got) == data
    data = gen().read(5_000)
    for name in ("encode_fse", "encode_vn", "encode_raw"):
        assert getattr(port_frontend, name)(data) == getattr(
            jax_frontend, name)(data)


def _pushed(mk, src: bytes, chunk: int):
    """``src`` pushed through a stream decoder in chunks: the output, or
    the exception's class name and message."""
    def run():
        dec = mk()
        out = bytearray()
        i = 0
        while i < len(src):
            i += dec.push(src[i:i + chunk])
            out += dec.pull()
        out += dec.pull()
        dec.finish()
        return bytes(out)
    return _outcome(run)


@pytest.mark.parametrize("family", [name for name, _ in FAMILIES])
def test_spec_stream_decoder_equals_the_original(family):
    """The port's ``SpecStreamDecoder`` against the original on the kit
    families' containers (natively encoded, so FSE, LZVN and RAW blocks
    all occur) and on their truncated and extended copies."""
    gen = dict(FAMILIES)[family]
    nat = native_runtime()
    for size in (0, 3_000, 200_000):
        good = nat.encode_bytes(gen().read(size))
        for src in (good, good[:len(good) // 2], good + b"\x00"):
            for chunk in (13, 4096):
                want = _pushed(jax_streaming.SpecStreamDecoder, src, chunk)
                assert _pushed(port_streaming.SpecStreamDecoder, src,
                               chunk) == want
