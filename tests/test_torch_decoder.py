"""TorchDecoder against the JAX reference decoder and the spec layer.

On the CPU the decoder runs its kernels' plain versions. One mixed batch
(FSE, LZVN, RAW and empty containers) must decode to the same bytes as
``TpuDecoder`` with its Pallas kernels in interpret mode; malformed
containers must raise as the JAX path raises (the port raises its own
error classes, with the JAX package's names and messages); more seeded
batches and corrupted payloads are held against the spec layer.
"""

import numpy as np
import pytest

from jax.experimental import pallas as pl

from lzfse_rust_tpu.models.decoder import TpuDecoder
from lzfse_rust_tpu.spec import container as spec_container
from lzfse_rust_tpu_torch import TorchDecoder
from lzfse_rust_tpu_torch.base import errors as port_errors
from lzfse_rust_tpu_torch.ops import cuda_decode as K
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.utils import corpus

STAGES = {"parse", "prep", "device", "flatten", "rebuild", "detail_prep"}


@pytest.fixture(scope="module")
def dec():
    return TorchDecoder("cpu")


@pytest.fixture(scope="module")
def mixed():
    return corpus.small_batch(seed=21, n_fse=5, lo=3_000, hi=16_000)


def _outcome(fn):
    """The result of fn(), or the class name and message of the exception
    it raised (each package raises its own classes of the same names)."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the exception is the result
        return (type(exc).__name__, str(exc))


def test_equals_tpu_decoder_interpret(mixed, dec, monkeypatch):
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    sources = [c for _, c in mixed]
    assert {b"bvx2", b"bvxn", b"bvx-", b"bvx$"} <= {c[:4] for c in sources}
    jax_stats: dict = {}
    want = TpuDecoder(use_pallas=True,
                      use_native_rebuild=True).decode_many(sources, jax_stats)
    stats: dict = {}
    got = dec.decode_many(sources, stats)
    assert got == want
    assert got == [r for r, _ in mixed]
    assert jax_stats.get("fallbacks", 0) == 0
    assert stats.get("fallbacks", 0) == 0


def test_decode_bytes_equals_tpu_decoder_and_native(mixed, dec,
                                                   monkeypatch):
    """``decode_bytes`` on each container alone against the native decoder,
    and on the smallest container of each kind (FSE, LZVN, RAW, empty)
    against ``TpuDecoder.decode_bytes`` in interpret mode."""
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    nat = native_runtime()
    smallest: dict = {}
    for raw, c in mixed:
        assert dec.decode_bytes(c) == raw == nat.decode_bytes(c)
        if len(c) < len(smallest.get(c[:4], (None, c + b"."))[1]):
            smallest[c[:4]] = (raw, c)
    assert {b"bvx2", b"bvxn", b"bvx-", b"bvx$"} <= set(smallest)
    ref = TpuDecoder(use_pallas=True, use_native_rebuild=True)
    for raw, c in smallest.values():
        assert dec.decode_bytes(c) == ref.decode_bytes(c) == raw


@pytest.mark.parametrize("case", ["truncated", "trailing", "bad_magic",
                                  "zero_header", "empty_input"])
def test_malformed_raises_as_jax_path(case, mixed, dec):
    good = next(c for _, c in mixed if c[:4] == b"bvx2")
    bad = {"truncated": good[:len(good) // 2],
           "trailing": good + b"\x00\x01",
           "bad_magic": b"bvxZ" + good[4:],
           "zero_header": b"bvx2" + b"\x00" * 40,
           "empty_input": b""}[case]
    ref = TpuDecoder(use_pallas=True, use_native_rebuild=True)
    want = _outcome(lambda: ref.decode_many([good, bad]))
    got = _outcome(lambda: dec.decode_many([good, bad]))
    assert isinstance(want, tuple) and hasattr(port_errors, want[0])
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_seeded_batches_equal_spec(seed, dec):
    pairs = corpus.small_batch(seed=200 + seed, n_fse=4, lo=2_000,
                               hi=24_000)
    sources = [c for _, c in pairs]
    stats: dict = {}
    got = dec.decode_many(sources, stats)
    assert got == [spec_container.decode_bytes(c) for c in sources]
    assert got == [r for r, _ in pairs]
    assert STAGES <= set(stats)
    assert stats.get("fallbacks", 0) == 0
    # a second call reuses the staging buffers; nothing may bleed across
    assert dec.decode_many(sources[::-1]) == [r for r, _ in pairs][::-1]


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_payload_matches_spec(seed, mixed, dec):
    """A flipped payload byte gets past the container walk; the stream
    checks or the rebuild must then send the container to the spec layer,
    so the result (bytes or exception type) is the spec layer's."""
    rng = np.random.default_rng(seed)
    fse = [c for _, c in mixed if c[:4] == b"bvx2"]
    c = bytearray(fse[seed % len(fse)])
    at = int(rng.integers(len(c) // 2, len(c) - 4))
    c[at] ^= 1 << int(rng.integers(8))
    c = bytes(c)
    want = _outcome(lambda: spec_container.decode_bytes(c))
    stats: dict = {}
    got = _outcome(lambda: dec.decode_many([c], stats)[0])
    assert got == want
    if isinstance(want, tuple):
        assert stats.get("fallbacks", 0) >= 1


def test_batch_without_fse_blocks(dec):
    pairs = [(r, corpus.encode(r)) for r in
             (b"abcabcabc" * 20, bytes(range(256)) * 3, b"")]
    pairs.append((b"", corpus.EMPTY))
    assert not any(c[:4] == b"bvx2" for _, c in pairs)
    assert dec.decode_many([c for _, c in pairs]) == [r for r, _ in pairs]


def test_kernel_args_match_decoder_layout(mixed, dec):
    lit, lmd = dec.kernel_args([c for _, c in mixed])
    nb = lit["tables"].shape[0]
    assert lit["states"].shape == (nb, 4) and lmd["states"].shape == (nb, 3)
    # size-sorted slots: counts never grow along the batch
    assert (lit["num"][:-1] >= lit["num"][1:]).all()
    assert (lmd["num"][:-1] >= lmd["num"][1:]).all()
    assert lit["n_out"] == int(K.literal_counts(lit["num"].numpy()).sum())
    assert lmd["n_out"] == int(lmd["num"].sum())
