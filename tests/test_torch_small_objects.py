"""Small cached values through every path of ``TorchDecoder``, on the CPU.

The batch follows the rule of the benchmark's ``memcached_etc``
configuration at 512 quantiles: the value sizes of Facebook's ETC Memcached
pool as a Generalized Pareto fit (Atikoglu et al., SIGMETRICS 2012: scale
214.476, shape 0.348238), taken at the fit's mid-quantiles, with text,
html, urls and binary content in turn. That gives 46 values of at most 20
bytes (RAW blocks), one above 4 KiB (an FSE block) and LZVN or RAW blocks
for the rest; a 5,000 B and a 13,584 B value add two more FSE containers.
With the native rebuild, containers with no FSE block never reach the
device: their LZVN and RAW blocks are decoded on host threads. The device
rebuild writes every block's output on the device.

Every output must equal the raw input, the benchmark's plain reference
(``benchmark.reference.container``) and ``TpuDecoder(use_pallas=False)``,
on the default path, with the device rebuild and on the scan path; each
count of ``stats["detail_parts"]`` must equal what the reference's block
walk (``benchmark.reference.check.walk``) finds in the same batch.
"""

import pathlib
import sys

import pytest

from lzfse_rust_tpu.models.decoder import TpuDecoder
from lzfse_rust_tpu_torch import TorchDecoder
from lzfse_rust_tpu_torch.runtime.build import native_runtime
from lzfse_rust_tpu_torch.spec import container as spec_container

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import corpus  # noqa: E402
from benchmark.reference import check as CK  # noqa: E402
from benchmark.reference import container as RC  # noqa: E402

SIGMA, XI = 214.476, 0.348238
KINDS = ("text", "html", "urls", "binary")
SEED = 2**35 + 11
PATHS = {"default": {}, "device_rebuild": {"use_native_rebuild": False},
         "scan": {"use_kernels": False}}


def quantile_sizes(n: int) -> list[int]:
    """The fit's ``n`` mid-quantiles, rounded, at least 1 byte."""
    return [max(1, round(SIGMA / XI * ((1 - (i + 0.5) / n) ** -XI - 1)))
            for i in range(n)]


def make_batch(sizes, kinds, seed=SEED):
    """(raws, containers): value ``i`` is ``corpus.make_file(kinds[i],
    sizes[i], seed, i)``, encoded by the native encoder."""
    enc = native_runtime().encode_bytes
    raws = [corpus.make_file(k, s, seed, i)
            for i, (k, s) in enumerate(zip(kinds, sizes))]
    return raws, [enc(r) for r in raws]


# the block kinds whose output the card takes part in, by path: the native
# rebuild (default and scan paths) decodes LZVN and RAW blocks on the host,
# the device rebuild none
CARD_KINDS = {"default": ("fse",), "device_rebuild": ("fse", "vn", "raw"),
              "scan": ("fse",)}


def reference_counts(containers, path="default") -> dict:
    """``detail_parts`` as the reference's block walk counts it on
    ``path``."""
    blocks = [CK.walk(c) for c in containers]
    host_only = [bs for bs in blocks
                 if not any(b.kind in CARD_KINDS[path] for b in bs)]
    return {"containers": len(containers), "host_only": len(host_only),
            "host_only_bytes": sum(b.n_raw for bs in host_only for b in bs),
            "raw_bytes": sum(b.n_raw for bs in blocks for b in bs),
            **{f"{k}_blocks": sum(b.kind == k for bs in blocks for b in bs)
               for k in ("fse", "vn", "raw")}}


@pytest.fixture(scope="module")
def etc():
    sizes = quantile_sizes(512)
    assert sum(s <= 20 for s in sizes) == 46
    assert sum(s > 4096 for s in sizes) == 1
    sizes += [5_000, 13_584]
    kinds = [KINDS[i % 4] for i in range(512)] + ["text", "binary"]
    return make_batch(sizes, kinds)


@pytest.fixture(scope="module")
def jax_outputs(etc):
    return TpuDecoder(use_pallas=False).decode_many(etc[1])


def test_batch_holds_every_block_kind(etc):
    raws, conts = etc
    want = reference_counts(conts)
    assert want["fse_blocks"] == 3 and want["containers"] == 514
    assert want["raw_blocks"] >= 46 and want["vn_blocks"] > 100
    assert {c[:4] for c in conts} == {b"bvx2", b"bvxn", b"bvx-"}
    assert [RC.decode_bytes(c) for c in conts] == raws


@pytest.mark.parametrize("path", PATHS)
def test_every_path_equals_the_raw_inputs_and_references(path, etc,
                                                         jax_outputs):
    raws, conts = etc
    stats: dict = {}
    got = TorchDecoder("cpu", **PATHS[path]).decode_many(conts, stats)
    assert got == raws == jax_outputs
    assert got == [RC.decode_bytes(c) for c in conts]
    assert stats.get("fallbacks", 0) == 0
    assert stats["detail_parts"] == reference_counts(conts, path)
    assert stats["walks"] == 1


@pytest.mark.parametrize("path", PATHS)
def test_batch_without_fse_blocks(path, etc):
    raws, conts = etc
    keep = [i for i, c in enumerate(conts) if c[:4] != b"bvx2"]
    raws = [raws[i] for i in keep]
    conts = [conts[i] for i in keep]
    stats: dict = {}
    got = TorchDecoder("cpu", **PATHS[path]).decode_many(conts, stats)
    assert got == raws
    assert stats.get("fallbacks", 0) == 0
    parts = stats["detail_parts"]
    assert parts == reference_counts(conts, path)
    assert parts["fse_blocks"] == 0
    assert parts["raw_bytes"] == sum(map(len, raws))
    if path != "device_rebuild":
        assert parts["host_only"] == parts["containers"] == len(conts)
        assert parts["host_only_bytes"] == parts["raw_bytes"]
    else:   # the device rebuild writes every block's output
        assert parts["host_only_bytes"] == 0
        assert parts["host_only"] == sum(r == b"" for r in raws)


def test_counts_add_up_over_calls_and_leave_out_rejected(etc):
    """Two calls into one ``stats`` add their counts; a container the walk
    rejects is counted among the containers and nowhere else, also when
    the call then raises its exception; empty containers (no block) beside
    it and beside FSE containers leave each FSE block with its owner."""
    raws, conts = etc
    dec = TorchDecoder("cpu")
    stats: dict = {}
    dec.decode_many(conts[:40], stats)
    dec.decode_many(conts[40:], stats)
    assert stats["detail_parts"] == reference_counts(conts)
    # a RAW container whose header says more bytes than it holds
    raw = next(c for c in conts if c[:4] == b"bvx-" and len(c) > 16)
    bad = raw[:4] + (int.from_bytes(raw[4:8], "little") + 4).to_bytes(
        4, "little") + raw[8:]
    empty = native_runtime().encode_bytes(b"")
    fse = [c for c in conts if c[:4] == b"bvx2"]
    good = [empty, fse[0], *conts[:6], empty, empty, fse[1], empty]
    stats = {}
    with pytest.raises(Exception) as want:
        spec_container.decode_bytes(bad)
    with pytest.raises(type(want.value)):
        dec.decode_many(good[:9] + [bad] + good[9:], stats)
    counts = reference_counts(good)
    assert counts["fse_blocks"] == 2 and counts["host_only"] == 10
    assert stats["detail_parts"] == {**counts, "containers": 13}


def test_thousands_of_containers_outgrow_the_walk_capacity(etc):
    """Four copies of the batch, 2,056 values, each three in turn joined
    into one container of their blocks: 686 containers with more parts
    than the native walk's first capacity (1,024 parts, and at least one a
    container), so a new decoder's walk grows and walks again; every
    output is still the raw input. The decoder's next call starts from the
    capacity the first one reached and walks once."""
    raws, conts = (x * 4 for x in etc)
    raws = [b"".join(raws[i:i + 3]) for i in range(0, len(raws), 3)]
    conts = [b"".join(c[:-4] for c in conts[i:i + 3]) + b"bvx$"
             for i in range(0, len(conts), 3)]
    want = reference_counts(conts)
    assert want["containers"] == 686
    assert want["fse_blocks"] + want["vn_blocks"] + want["raw_blocks"] > 1024
    dec = TorchDecoder("cpu")
    for walks in (2, 1):
        stats: dict = {}
        assert dec.decode_many(conts, stats) == raws
        assert stats.get("fallbacks", 0) == 0
        assert stats["detail_parts"] == want
        assert stats["walks"] == walks


def test_thousands_of_containers_walk_once(etc):
    """Four copies of the batch, 2,056 containers of one block each: more
    containers than the native walk's smallest first capacity (1,024
    parts), yet a new decoder walks once, since the first try holds a part
    a container; every output is still the raw input."""
    raws, conts = (x * 4 for x in etc)
    stats: dict = {}
    assert TorchDecoder("cpu").decode_many(conts, stats) == raws
    assert stats.get("fallbacks", 0) == 0
    assert stats["detail_parts"] == reference_counts(conts)
    assert stats["detail_parts"]["containers"] == 2056
    assert stats["walks"] == 1
