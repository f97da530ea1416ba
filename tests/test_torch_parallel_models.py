"""``TorchDecoder(mesh=)`` and ``TorchEncoder(mesh=)`` against the JAX
package's ``TpuDecoder(mesh=)`` and ``TpuEncoder(mesh=)``, on the CPU.

JAX runs on two of its virtual CPU devices (its decode kernels in interpret
mode through a patched ``pl.pallas_call``), the port on ``make_mesh(["cpu"]
* n)``. Inputs are ``tests/kit.py`` word streams and seeded corpus data
encoded in the repository. Outputs are bytes: every comparison is exact.
"""

import jax
import numpy as np
import pytest
from jax.experimental import pallas as pl

import kit
from lzfse_rust_tpu import api
from lzfse_rust_tpu.models.decoder import TpuDecoder
from lzfse_rust_tpu.models.encoder import TpuEncoder
from lzfse_rust_tpu.parallel.mesh import make_mesh as jax_mesh
from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
from lzfse_rust_tpu_torch.parallel.mesh import make_mesh
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.utils import corpus


@pytest.fixture
def interpret(monkeypatch):
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))


def test_decoder_mesh_equals_tpu_decoder_mesh(interpret):
    raws = [kit.WordSeq(seed=s).read(6_000 + 3_000 * s) for s in range(2)]
    raws.append(b"mesh serving, mesh serving, mesh serving!")
    sources = [api.encode_bytes(r) for r in raws]
    assert [s[:4] for s in sources] == [b"bvx2", b"bvx2", b"bvxn"]
    want = TpuDecoder(use_native_rebuild=True,
                      mesh=jax_mesh(jax.devices()[:2])).decode_many(sources)
    stats: dict = {}
    got = TorchDecoder("cpu", mesh=make_mesh(["cpu"] * 2)).decode_many(
        sources, stats)
    assert got == [bytes(w) for w in want] == raws
    assert stats.get("fallbacks", 0) == 0


@pytest.mark.parametrize("n", [3, 5])
def test_decoder_mesh_uneven_shards_equal_one_device(n):
    """More shards than divide the blocks: the sorted batch is padded with
    inert slots, and the bytes are the unsharded decoder's."""
    mixed = corpus.small_batch(seed=41, n_fse=4, lo=3_000, hi=30_000)
    sources = [c for _, c in mixed]
    stats: dict = {}
    got = TorchDecoder("cpu", mesh=make_mesh(["cpu"] * n)).decode_many(
        sources, stats)
    assert got == TorchDecoder("cpu").decode_many(sources)
    assert got == [r for r, _ in mixed]
    assert stats.get("fallbacks", 0) == 0


@pytest.mark.parametrize("option", ["use_kernels", "use_native_rebuild"])
def test_decoder_mesh_needs_the_kernel_path(option):
    with pytest.raises(ValueError, match="use_kernels and use_native_rebuild"):
        TorchDecoder("cpu", mesh=make_mesh(["cpu"] * 2), **{option: False})


def test_mesh_devices_must_be_of_the_decoders_type():
    with pytest.raises(ValueError, match="not all of type 'cpu'"):
        TorchDecoder("cpu", mesh=make_mesh(["cpu", "cuda:0"]))
    with pytest.raises(ValueError, match="not all of type 'cpu'"):
        TorchEncoder("cpu", mesh=make_mesh(["cuda:0"]))


def test_encoder_mesh_equals_tpu_encoder_mesh_and_native():
    rng = np.random.default_rng(43)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(64)]
    sources = [
        b" ".join(words[int(i)] for i in rng.integers(0, 64, 1200)),
        b" ".join(words[int(i)] for i in rng.integers(0, 64, 5000)),
        bytes(rng.integers(0, 256, 9000, dtype=np.uint8)),
        corpus.make_raw("html", 70_000, rng),
    ]
    want = TpuEncoder(device_emission=False,
                      mesh=jax_mesh(jax.devices()[:2])).encode_many(sources)
    nat = native_runtime()
    assert want == [nat.encode_bytes(s) for s in sources]
    for n in (2, 3):
        for emission in (True, False):
            enc = TorchEncoder("cpu", mesh=make_mesh(["cpu"] * n),
                               device_emission=emission)
            stats: dict = {}
            assert enc.encode_many(sources, stats) == want
            assert enc.last_emission == ("device" if emission else "host")
            assert all("sharded_ms" not in d and d["windows"] >= 1
                       for d in stats["detail_match"])
            assert enc.encode_bytes(sources[-1]) == want[-1]


def test_encoder_mesh_implies_the_device_frontend():
    mesh = make_mesh(["cpu"] * 2)
    assert TorchEncoder("cpu", mesh=mesh).frontend == "device"
    assert TorchEncoder("cpu").frontend == "native"
    with pytest.raises(ValueError, match="shards the device frontend"):
        TorchEncoder("cpu", frontend="native", mesh=mesh)


def test_encoder_mesh_with_host_emission_shards_the_windows():
    """``TpuEncoder(device_emission=False, frontend="native", mesh=...)``
    runs the device windows on its mesh: the port takes that combination
    too (its native frontend is not run) and gives the same containers."""
    rng = np.random.default_rng(44)
    sources = [corpus.make_raw("text", 30_000, rng), b"short",
               corpus.make_raw("urls", 20_000, rng)]
    mesh = jax_mesh(jax.devices()[:2])
    ref = TpuEncoder(device_emission=False, frontend="native", mesh=mesh)
    want = ref.encode_many(sources)
    assert ref.last_emission == "host"
    enc = TorchEncoder("cpu", frontend="native", mesh=make_mesh(["cpu"] * 2),
                       device_emission=False)
    stats: dict = {}
    assert enc.encode_many(sources, stats) == want
    assert enc.last_emission == "host" and "detail_match" in stats
