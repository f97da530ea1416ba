"""Host emission, ``TorchEncoder(device_emission=False)``, against the JAX
package's ``TpuEncoder(device_emission=False)`` on the CPU.

The device windows find the matches (on the CPU, the grouped match
kernel's plain version, or the argsort branch under ``LZT_DEV_GROUPED=0``)
and ``native.select_emit_fse`` selects and emits each source's blocks on
the host. One seeded batch holds inputs of 0, 1, ``VN_CUTOFF`` and
``VN_CUTOFF + 1`` bytes, ``tests/kit.py`` word and Fibonacci streams,
``utils/corpus.make_raw`` text, html, urls and binary, an incompressible
source and a source of two windows. Every container must equal the JAX
encoder's and ``native.encode_bytes``, byte for byte, through
``encode_many`` and ``encode_bytes``, with ``last_emission == "host"``.
The JAX encoder is shared per module and its outputs cached per setting:
each window size compiles once.
"""

import os

import numpy as np
import pytest

import kit
from lzfse_rust_tpu.base import constants as JC
from lzfse_rust_tpu.models.encoder import TpuEncoder
from lzfse_rust_tpu_torch import TorchEncoder
from lzfse_rust_tpu_torch.base import constants as C
from lzfse_rust_tpu_torch.base.errors import LzfseError
from lzfse_rust_tpu_torch.models import encoder as M
from lzfse_rust_tpu_torch.ops import cuda_encode as K
from lzfse_rust_tpu_torch.ops import match_find as MF
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.utils import corpus

HOST_STAGES = {"small", "win_prep", "matchfind", "arbitrate", "merge",
               "select_emit"}
DEVICE_ONLY = {"select", "emit_prep", "emit_dispatch", "emit_kernels",
               "pack", "frontend", "detail_device", "upload_bytes",
               "download_bytes"}


def _batch() -> list[bytes]:
    rng = np.random.default_rng(61)
    assert C.VN_CUTOFF == JC.VN_CUTOFF
    return [b"", b"a", b"x" * C.VN_CUTOFF,
            corpus.make_raw("text", C.VN_CUTOFF + 1, rng),
            kit.WordSeq(seed=3).read(30_000),
            kit.Fibonacci().read(12_000),
            corpus.make_raw("html", 40_000, rng),
            corpus.make_raw("urls", 25_000, rng),
            corpus.make_raw("binary", 20_000, rng),
            bytes(rng.integers(0, 256, 20_000, dtype=np.uint8)),
            corpus.make_raw("text", M.WINDOW_STRIDE + 30_000, rng)]


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def nat():
    return native_runtime()


@pytest.fixture(scope="module")
def ref():
    enc = TpuEncoder(device_emission=False)
    assert (enc.frontend, enc.device_emission) == ("device", False)
    return enc


@pytest.fixture(scope="module")
def enc():
    return TorchEncoder("cpu", device_emission=False)


_WANT: dict = {}


def _grouped(monkeypatch, setting: str) -> None:
    if setting == "1":
        monkeypatch.delenv("LZT_DEV_GROUPED", raising=False)
    else:
        monkeypatch.setenv("LZT_DEV_GROUPED", setting)


def _want(ref, batch, setting: str) -> list[bytes]:
    """The JAX encoder's ``encode_many`` on the batch under
    ``LZT_DEV_GROUPED=setting`` (cached; the caller has set it)."""
    assert os.environ.get("LZT_DEV_GROUPED", "1") == setting
    if setting not in _WANT:
        _WANT[setting] = ref.encode_many(batch)
        assert ref.last_emission == "host"
    return _WANT[setting]


def test_the_batch_covers_the_edges(batch, enc):
    sizes = [len(s) for s in batch]
    assert sizes[:4] == [0, 1, C.VN_CUTOFF, C.VN_CUTOFF + 1]
    wins = enc.windows(batch)
    assert [w[2] for w in wins if w[0] == len(batch) - 1] == [0,
                                                              M.WINDOW_CTX]
    assert len({w[4] for w in wins}) >= 4


@pytest.mark.parametrize("setting", ["1", "0"])
def test_encode_many_equals_tpu_encoder(setting, batch, ref, enc, nat,
                                        monkeypatch):
    """``LZT_DEV_GROUPED`` 1 (the grouped match kernel's plain version)
    and 0 (the argsort branch): the JAX encoder's containers, the native
    encoder's, and the host stages only."""
    _grouped(monkeypatch, setting)
    want = _want(ref, batch, setting)
    stats: dict = {}
    got = enc.encode_many(batch, stats)
    assert enc.last_emission == ref.last_emission == "host"
    assert got == want
    assert got == [nat.encode_bytes(s) for s in batch]
    assert HOST_STAGES <= set(stats) and not DEVICE_ONLY & set(stats)
    assert sum(d["windows"] for d in stats["detail_match"]) == len(
        enc.windows(batch))


@pytest.mark.parametrize("setting", ["1", "0"])
def test_encode_bytes_equals_tpu_encoder(setting, batch, ref, enc, nat,
                                         monkeypatch):
    _grouped(monkeypatch, setting)
    want = _want(ref, batch, setting)
    for src, w in zip(batch, want):
        enc.last_emission = None
        got = enc.encode_bytes(src)
        assert got == w == nat.encode_bytes(src), len(src)
        if len(src) > C.VN_CUTOFF:
            assert enc.last_emission == "host"
    two = batch[-1]
    assert ref.encode_bytes(two) == want[-1]
    assert ref.last_emission == "host"


def test_default_frontend_is_the_device_windows():
    assert TorchEncoder("cpu", device_emission=False).frontend == "device"
    assert TpuEncoder(device_emission=False).frontend == "device"
    assert TorchEncoder("cpu").device_emission is True
    assert TorchEncoder("cpu").frontend == "native"


def test_frontend_native_is_not_run_under_host_emission(batch, ref, nat,
                                                        monkeypatch):
    """As in the JAX encoder, whose native branches need device emission
    too: ``frontend="native"`` is kept but the device windows find the
    matches, and the containers are the same."""
    _grouped(monkeypatch, "1")
    want = _want(ref, batch, "1")
    jax_native = TpuEncoder(device_emission=False, frontend="native")
    assert jax_native.frontend == "native"
    assert jax_native.encode_many(batch[:8]) == want[:8]
    assert jax_native.last_emission == "host"
    enc = TorchEncoder("cpu", frontend="native", device_emission=False)
    assert enc.frontend == "native"
    for name in ("frontend_stage", "frontend_blocks"):
        monkeypatch.setattr(nat, name, lambda *a, **k: pytest.fail(
            "the native frontend ran under host emission"))
    stats: dict = {}
    assert enc.encode_many(batch, stats) == want
    assert "detail_match" in stats and enc.last_emission == "host"
    assert enc.encode_bytes(batch[6]) == want[6]


def test_select_emit_once_a_source_and_match_rows_once_a_window_size(
        batch, enc, nat, monkeypatch):
    """A spy on each call: ``select_emit_fse`` once per source above
    ``VN_CUTOFF``, the plain ``match_rows`` once per window size, and
    neither encode kernel nor the device path's selection."""
    _grouped(monkeypatch, "1")
    calls = {"select_emit": [], "match_rows": []}
    real_emit, real_rows = nat.select_emit_fse, MF.match_rows_ref

    def emit(src, rows):
        calls["select_emit"].append(len(src))
        return real_emit(src, rows)

    def rows(pads, *a, **k):
        calls["match_rows"].append(tuple(pads.shape))
        return real_rows(pads, *a, **k)

    monkeypatch.setattr(nat, "select_emit_fse", emit)
    monkeypatch.setattr(MF, "match_rows_ref", rows)
    for name in ("encode_literals", "encode_lmds"):
        monkeypatch.setattr(K, name, lambda *a, **k: pytest.fail(
            "an encode kernel ran under host emission"))
    monkeypatch.setattr(nat, "select_blocks", lambda *a, **k: pytest.fail(
        "select_blocks ran under host emission"))
    enc.encode_many(batch)
    big = [len(s) for s in batch if len(s) > C.VN_CUTOFF]
    assert sorted(calls["select_emit"]) == sorted(big)
    sizes = sorted({w[4] for w in enc.windows(batch)})
    assert [n for _, n in calls["match_rows"]] == sizes
    assert sum(b for b, _ in calls["match_rows"]) == len(enc.windows(batch))


def test_a_failing_select_emit_raises(batch, enc, nat, monkeypatch):
    """No other encoder takes over: neither the native encoder, nor the
    native frontend, nor device emission."""
    def boom(src, rows):
        raise LzfseError("select_emit failed: -3")

    monkeypatch.setattr(nat, "select_emit_fse", boom)
    for name in ("encode_bytes", "frontend_stage", "frontend_blocks",
                 "select_blocks"):
        monkeypatch.setattr(nat, name, lambda *a, **k: pytest.fail(
            "another encoder took over"))
    bigs = [s for s in batch if len(s) > C.VN_CUTOFF][:3]
    with pytest.raises(LzfseError, match="select_emit failed: -3"):
        enc.encode_many(bigs)
    with pytest.raises(LzfseError, match="select_emit failed: -3"):
        enc.encode_bytes(bigs[0])


def test_small_inputs_take_the_native_encoder(enc, nat):
    small = [b"", b"a", b"ab" * 1000]
    assert all(len(s) <= C.VN_CUTOFF for s in small)
    assert enc.encode_many(small) == [nat.encode_bytes(s) for s in small]
