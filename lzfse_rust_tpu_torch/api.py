"""Public API objects: buffer engines, streaming engines, IO adapters.

Port of ``lzfse_rust_tpu/api.py``, with the same names, return values and
byte accounting. It mirrors the four API shapes of the reference crate
(src/lib.rs:138-142): one-shot bytes, reusable engine objects, push-style
writer, pull-style reader.

The batch entry points ``encode_many`` and ``decode_many`` run on the card
by default: ``device="cuda"`` sends the batch to ``TorchEncoder`` /
``TorchDecoder`` (``models/``), and ``device="cpu"`` runs the JAX API's
host thread pool. The one-shot and streaming engines run on the host, in
the port's native C++ runtime (``runtime/native.py`` over the library that
``runtime/build.py`` builds from the checkout at first use); a runtime that
cannot be built raises ``BuildError``. The spec layer's streaming engines
(``_SpecStreamEncoder`` below, ``spec.streaming.SpecStreamDecoder``) and
``spec.frontend.encode_bytes`` follow the same protocols and are kept as
executable references.
"""

from __future__ import annotations

import functools
import io
import threading
from typing import BinaryIO

import torch

from .base.errors import LzfseError
from .spec import container as _spec_container

# Streaming window: matches confined to chunks of this size keep memory
# bounded for unbounded streams, mirroring the ring encoder's 512KB window
# semantics (src/encode/frontend_ring.rs:44-106).
STREAM_CHUNK = 0x80000


@functools.cache
def _native():
    """The port's native runtime module, built at first use; raises
    ``runtime.build.BuildError`` when it cannot be built or loaded."""
    from .runtime.build import native_runtime
    return native_runtime()


def encode_bytes(src: bytes) -> bytes:
    """One-shot buffer encode (reference: src/encode/mod.rs:58).

    Inputs beyond the 32-bit index range route through the sliding-window
    stream engine — the role of the reference's BLOCK_GUIDE windowing + index
    rebias (frontend_bytes.rs:346-375): window-local coordinates stay small
    while matches keep the full 262139-byte reach across window seams.
    """
    if len(src) > 0x7FFFF000:
        enc = _new_stream_encoder()
        out = []
        mv = memoryview(src)
        for i in range(0, len(src), _IO_CHUNK):
            enc.push(bytes(mv[i:i + _IO_CHUNK]))
            out.append(enc.pull())
        enc.finish()
        while True:
            got = enc.pull()
            if not got:
                break
            out.append(got)
        return b"".join(out)
    return _native().encode_bytes(src)


def decode_bytes(src: bytes) -> bytes:
    """One-shot buffer decode (reference: src/decode/mod.rs:49)."""
    return _native().decode_bytes(src)


@functools.cache
def _card(kind: str, device: torch.device):
    """The batch engine ``kind`` ("decode" or "encode") on ``device``, kept
    for reuse with the lock that serialises its calls (its staging buffers
    belong to it)."""
    from .models.decoder import TorchDecoder
    from .models.encoder import TorchEncoder
    engine = TorchDecoder if kind == "decode" else TorchEncoder
    return engine(device), threading.Lock()


def _on_card(device) -> bool:
    """True for a CUDA device, False for the CPU (the host thread pool)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: 'cuda' or 'cpu'")
    return kind == "cuda"


def decode_many(sources, max_workers: int | None = None,
                device="cuda") -> list[bytes]:
    """Decode a batch of independent containers.

    ``device="cuda"`` (the default) decodes the batch in one call of
    ``TorchDecoder`` on the card; a CUDA device without a card raises.
    A malformed batch, whatever its element types (a ``memoryview`` or a
    ``bytearray`` too), raises what the host route raises on it: the JAX
    API's class and message, for the first bad container in batch order.
    ``device="cpu"`` decodes on a host thread pool of ``max_workers``: the
    native runtime releases the GIL during calls, so the pool scales across
    cores. Either way the results are byte-identical to sequential decodes.
    """
    sources = list(sources)
    if not sources:
        return []
    if not _on_card(device):
        return _decode_many_host(sources, max_workers)
    odd = [type(s).__name__ for s in sources if not isinstance(s, bytes)]
    if odd:
        # the card's parse takes bytes objects only; the host route's
        # ctypes calls reject the others with the JAX API's error
        _decode_many_host(sources, max_workers)
        raise TypeError(f"decode_many: containers must be bytes, got {odd[0]}")
    dec, lock = _card("decode", torch.device(device))
    try:
        with lock:
            return dec.decode_many(sources)
    except LzfseError:
        # the card names the fault in its own words; raise the host
        # route's error for the first bad container, as the JAX API does
        _decode_many_host(sources, max_workers)
        raise


def _decode_many_host(sources: list, max_workers: int | None) -> list:
    from concurrent.futures import ThreadPoolExecutor
    if len(sources) <= 1:
        return [decode_bytes(s) for s in sources]
    n = _native()
    # container-level parallelism only: the per-container mt engine would
    # nest its own pool under this one and oversubscribe the cores
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(lambda s: n.decode_bytes(s, parallel=False),
                             sources))


def encode_many(sources, max_workers: int | None = None,
                device="cuda") -> list[bytes]:
    """Encode a batch of independent buffers; each output is byte-identical
    to its sequential ``encode_bytes`` result.

    ``device="cuda"`` (the default) encodes the batch in one call of
    ``TorchEncoder``, whose block emission runs on the card; a CUDA device
    without a card raises. ``device="cpu"`` encodes on a host thread pool
    of ``max_workers``. Either way an input beyond the 32-bit index range
    takes ``encode_bytes``'s window route on the host.
    """
    sources = list(sources)
    if not _on_card(device):
        return _encode_many_host(sources, max_workers)
    out = [encode_bytes(s) if len(s) > 0x7FFFF000 else None for s in sources]
    rest = [i for i, o in enumerate(out) if o is None]
    if rest:
        enc, lock = _card("encode", torch.device(device))
        with lock:
            for i, o in zip(rest, enc.encode_many([sources[i]
                                                   for i in rest])):
                out[i] = o
    return out


def _encode_many_host(sources: list, max_workers: int | None) -> list:
    from concurrent.futures import ThreadPoolExecutor
    if len(sources) <= 1:
        return [encode_bytes(s) for s in sources]
    n = _native()

    def one(s):
        if len(s) > 0x7FFFF000:  # BLOCK_GUIDE window route, as encode_bytes
            return encode_bytes(s)
        # sequential engine per container: the emission-parallel engine
        # would nest its own pool under this one
        return n.encode_bytes(s, parallel=False)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, sources))


def probe(src: bytes) -> tuple[int, int]:
    """Return (n_payload_bytes, n_raw_bytes) without decompressing
    (reference: src/decode/probe.rs:11-35)."""
    return _spec_container.probe(src)


class LzfseEncoder:
    """Reusable buffer encoder (reference: LzfseEncoder, encoder.rs:14-58)."""

    def encode_bytes(self, src: bytes) -> bytes:
        return encode_bytes(src)


class LzfseDecoder:
    """Reusable buffer decoder (reference: LzfseDecoder, decoder.rs:17-99)."""

    def decode_bytes(self, src: bytes) -> bytes:
        return decode_bytes(src)


def _new_stream_encoder():
    """Incremental encoder: the native sliding-window engine (matches cross
    chunk boundaries up to the 262139-byte Goldilocks reach,
    frontend_ring.rs:44-106)."""
    return _native().StreamEncoder()


class _SpecStreamEncoder:
    """Window-chunked encoder with the same push/pull/finish protocol; its
    matches are confined to each 512 KB window."""

    def __init__(self):
        self._buf = bytearray()
        self._out = bytearray()
        self._finished = False

    def push(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= STREAM_CHUNK:
            window = bytes(self._buf[:STREAM_CHUNK])
            del self._buf[:STREAM_CHUNK]
            self._out += _encode_chunk_body(window)
        return len(data)

    def pull(self, cap: int | None = None) -> bytes:
        n = len(self._out) if cap is None else min(cap, len(self._out))
        out = bytes(self._out[:n])
        del self._out[:n]
        return out

    def finish(self) -> None:
        from .base import constants as C
        if self._finished:
            return
        if self._buf:
            self._out += _encode_chunk_body(bytes(self._buf))
            self._buf.clear()
        self._out += C.MAGIC_EOS.to_bytes(4, "little")
        self._finished = True


class LzfseRingEncoder:
    """Streaming encoder over IO objects (reference: LzfseRingEncoder,
    src/encode/ring_encoder.rs).

    Reads `reader` to EOF, encoding incrementally in constant memory.
    Matches reach back up to the format's maximum distance across chunk
    boundaries and FSE blocks span chunks — the ring encoder's Goldilocks
    matching. Returns (n_raw_bytes, n_payload_bytes), the byte accounting
    contract of ring_encoder.rs:55-67.
    """

    def writer(self, inner: BinaryIO) -> "LzfseWriter":
        """Push-encoder writing into an IO stream (ring_encoder writer)."""
        return LzfseWriter(inner)

    def writer_bytes(self) -> "LzfseWriterBytes":
        """Push-encoder accumulating into an owned buffer (writer_bytes)."""
        return LzfseWriterBytes()

    def encode(self, reader: BinaryIO, writer: BinaryIO) -> tuple[int, int]:
        enc = _new_stream_encoder()
        n_raw = 0
        n_payload = 0
        while True:
            chunk = reader.read(_IO_CHUNK)
            if not chunk:
                break
            n_raw += len(chunk)
            enc.push(chunk)
            while True:
                out = enc.pull()
                if not out:
                    break
                writer.write(out)
                n_payload += len(out)
        enc.finish()
        while True:
            out = enc.pull()
            if not out:
                break
            writer.write(out)
            n_payload += len(out)
        return n_raw, n_payload


def _encode_chunk_body(data: bytes) -> bytes:
    """Encode one window's blocks without the container EOS."""
    from .base import constants as C
    full = encode_bytes(data)
    assert full[-4:] == C.MAGIC_EOS.to_bytes(4, "little")
    return full[:-4]


def _new_stream_decoder():
    """Constant-memory incremental decoder: the native engine (O(1) state:
    bounded block carry + 1 MiB output ring)."""
    return _native().StreamDecoder()


_IO_CHUNK = 1 << 16


class LzfseRingDecoder:
    """Streaming decoder over IO objects (reference: LzfseRingDecoder,
    src/decode/ring_decoder.rs). Decodes unbounded streams in constant
    memory: input is fed in 64 KB chunks through the incremental stream
    decoder and output drained as it appears — nothing is ever materialized
    whole (reference counterpart: ReaderCore::fill + ring output,
    src/decode/reader_core.rs:56-99)."""

    def decode(self, reader: BinaryIO, writer: BinaryIO) -> tuple[int, int]:
        dec = _new_stream_decoder()
        n_payload = 0
        n_raw = 0
        while True:
            chunk = reader.read(_IO_CHUNK)
            if not chunk:
                break
            n_payload += len(chunk)
            off = 0
            while off < len(chunk):
                off += dec.push(chunk[off:])
                while True:
                    out = dec.pull()
                    if not out:
                        break
                    writer.write(out)
                    n_raw += len(out)
        while True:
            out = dec.pull()
            if not out:
                break
            writer.write(out)
            n_raw += len(out)
        dec.finish()
        return n_payload, n_raw

    def reader(self, inner: BinaryIO) -> "LzfseReader":
        """Wrap an IO stream in a pull-decoder (ring_decoder.rs reader)."""
        return LzfseReader(inner)

    def reader_bytes(self, data: bytes) -> "LzfseReaderBytes":
        """Pull-decoder over an in-memory buffer (reader_bytes)."""
        return LzfseReaderBytes(data)


class LzfseWriter(io.RawIOBase):
    """Push-style compressing writer (reference: LzfseWriter, writer.rs:39-75).

    Bytes written stream through the incremental encoder (cross-chunk
    Goldilocks matching); `close()` flushes the final block and the EOS
    magic.
    """

    def __init__(self, inner: BinaryIO):
        super().__init__()
        self._inner = inner
        self._enc = _new_stream_encoder()
        self._finalized = False

    def writable(self) -> bool:
        return True

    def _drain(self) -> None:
        while True:
            out = self._enc.pull()
            if not out:
                break
            self._inner.write(out)

    def write(self, data) -> int:
        self._enc.push(bytes(data))
        self._drain()
        return len(data)

    def close(self) -> None:
        if not self._finalized:
            self._enc.finish()
            self._drain()
            self._finalized = True
        super().close()


class LzfseWriterBytes(LzfseWriter):
    """Push-style writer accumulating into an owned buffer (reference:
    LzfseWriterBytes, writer_bytes.rs:44-78). Call .into_bytes() after
    close()."""

    def __init__(self):
        self._buf_out = io.BytesIO()
        super().__init__(self._buf_out)

    def into_bytes(self) -> bytes:
        if not self.closed:
            self.close()
        return self._buf_out.getvalue()


class LzfseReader(io.RawIOBase):
    """Pull-style decompressing reader (reference: LzfseReader,
    src/decode/reader.rs).

    Truly incremental: each read() pulls only as much as requested from the
    stream decoder, feeding compressed input in 64 KB chunks on demand.
    Memory stays O(1) regardless of stream size — the whole container is
    never materialized.
    """

    def __init__(self, inner: BinaryIO):
        super().__init__()
        self._inner = inner
        self._dec = _new_stream_decoder()
        self._buf = bytearray()
        self._in_eof = False
        self._finished = False

    def readable(self) -> bool:
        return True

    def _fill(self, want: int) -> None:
        """Grow the internal buffer to >= want bytes or hit end of stream."""
        while len(self._buf) < want and not self._finished:
            out = self._dec.pull()
            if out:
                self._buf += out
                continue
            if self._in_eof:
                self._dec.finish()  # validates EOS + no truncation
                self._finished = True
                break
            chunk = self._inner.read(_IO_CHUNK)
            if not chunk:
                self._in_eof = True
                continue
            off = 0
            while off < len(chunk):
                used = self._dec.push(chunk[off:])
                off += used
                if off < len(chunk):  # output backpressure: drain
                    out = self._dec.pull()
                    if out:
                        self._buf += out

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            parts = []
            while True:
                self._fill(_IO_CHUNK)
                if not self._buf:
                    break
                parts.append(bytes(self._buf))
                self._buf.clear()
            return b"".join(parts)
        self._fill(size)
        out = bytes(self._buf[:size])
        del self._buf[:size]
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class LzfseReaderBytes(LzfseReader):
    """Pull-style reader over an in-memory buffer (reference:
    LzfseReaderBytes). Decodes incrementally as the caller pulls."""

    def __init__(self, data: bytes):
        super().__init__(io.BytesIO(data))
