"""Package-level properties of the PyTorch port: it never imports JAX nor
the JAX package, its kernel modules import without a CUDA toolchain, builds
are cached and fail loudly, and a CUDA request without a card raises."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from lzfse_rust_tpu_torch.ops import cuda_decode as K
from lzfse_rust_tpu_torch.ops import cuda_encode as KE
from lzfse_rust_tpu_torch.runtime import build

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the port, its smoke script, and the test files that run on the card
# (where the port uses no JAX)
PORT_FILES = sorted((ROOT / "lzfse_rust_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_kit.py"]


def _python(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_import_leaves_jax_out():
    r = _python(
        "import sys\n"
        "import lzfse_rust_tpu_torch\n"
        "import lzfse_rust_tpu_torch.ops.cuda_decode\n"
        "import lzfse_rust_tpu_torch.ops.cuda_encode\n"
        "import lzfse_rust_tpu_torch.ops.fse_encode\n"
        "import lzfse_rust_tpu_torch.models.encoder\n"
        "import lzfse_rust_tpu_torch.runtime.cuda_lib\n"
        "import lzfse_rust_tpu_torch.utils.corpus\n"
        "import lzfse_rust_tpu_torch.utils.timing\n"
        "import lzfse_rust_tpu_torch.tools.block_size_probe\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_chip_smoke_reaches_jax_package_only_through_port():
    """chip_smoke.py and the port it imports load no module named
    ``lzfse_rust_tpu`` or ``lzfse_rust_tpu.*``: the port keeps its own
    copies of the host layers, so nothing reaches the JAX package."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+lzfse_rust_tpu\b", text, re.M)
    r = _python(
        "import sys\n"
        "import chip_smoke\n"
        "import lzfse_rust_tpu_torch\n"
        "from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'lzfse_rust_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)


def test_kernel_modules_import_without_nvcc():
    r = _python(
        "import lzfse_rust_tpu_torch.ops.cuda_decode as K\n"
        "import lzfse_rust_tpu_torch.ops.cuda_encode as KE\n"
        "import lzfse_rust_tpu_torch.models.encoder\n"
        "from lzfse_rust_tpu_torch.runtime import cuda_lib\n"
        "assert cuda_lib._LIB is None\n"
        "print('imported')\n", PATH="/nonexistent")
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_cpu_encode_loads_no_kernel_library():
    from lzfse_rust_tpu_torch import TorchEncoder
    from lzfse_rust_tpu_torch.runtime import cuda_lib
    if cuda_lib._LIB is not None:
        pytest.skip("the kernel library is already loaded")
    data = b"the port encodes on the CPU without its kernels " * 200
    enc = TorchEncoder("cpu")
    assert enc.encode_many([data]) == [enc.encode_bytes(data)]
    assert cuda_lib._LIB is None


@pytest.mark.parametrize("model", ["TorchDecoder", "TorchEncoder"])
def test_cuda_model_raises_without_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import lzfse_rust_tpu_torch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(lzfse_rust_tpu_torch, model)("cuda")


@pytest.mark.parametrize("model", ["TorchDecoder", "TorchEncoder"])
def test_unsupported_device_raises(model):
    import lzfse_rust_tpu_torch
    with pytest.raises(ValueError):
        getattr(lzfse_rust_tpu_torch, model)("meta")


def test_wrappers_have_no_path_for_other_devices():
    """Only CPU tensors take the plain version; any other device launches
    a kernel or raises."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")  # noqa: E731
    before = dict(K.launches)
    with pytest.raises(ValueError, match="no kernel"):
        K.decode_lmds(z(2, 384), z(8), z(2), z(2), z(2, 3), z(2), z(2),
                      z(2), 0)
    assert K.launches == before


def test_encode_wrappers_have_no_path_for_other_devices():
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")  # noqa: E731
    before = dict(KE.launches)
    with pytest.raises(ValueError, match="no kernel"):
        KE.encode_literals(z(2, 256), z(2, 8), z(2), z(2))
    with pytest.raises(ValueError, match="no kernel"):
        KE.encode_lmds(z(2, 20), z(2, 20), z(2, 64), z(2, 8), z(2, 8), z(2),
                       z(2))
    assert KE.launches == before


def test_build_kernels_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.build_kernels()


def test_failed_build_carries_compiler_stderr(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = tmp_path / "broken.cpp"
    src.write_text("int broken( {\n")
    cxx = shutil.which("g++") or "g++"
    with pytest.raises(build.BuildError, match="broken.cpp") as exc:
        build._build(tmp_path / "libbroken.so", [cxx, "-fPIC"],
                     [cxx, "-shared"], [src], "")
    assert "error" in str(exc.value)
    assert not (tmp_path / "libbroken.so").exists()


def test_native_build_is_cached_and_installed():
    """The port's own ``runtime.native`` is returned, running on the
    library built from the port's own copy of the C++ source."""
    from lzfse_rust_tpu_torch.runtime import native
    first = build.build_native()
    stamp = first.stat().st_mtime_ns
    assert build.build_native() == first
    assert first.stat().st_mtime_ns == stamp
    mod = build.native_runtime()
    assert mod is native and mod.__name__ == "lzfse_rust_tpu_torch.runtime.native"
    assert native._LIB._name == str(first)
    assert build.NATIVE_SRC.is_relative_to(build.PKG)
    data = b"the port rebuilds the native runtime " * 50
    assert native.decode_bytes(native.encode_bytes(data)) == data


def test_chip_smoke_bound_counts_this_batch():
    """The kernels line's bound: the larger of bytes over 3.35 TB/s and
    operations over 67 T/s, with each input read once and each output
    written once, counted from the batch's own arguments."""
    import chip_smoke
    assert chip_smoke.bound(3_350_000_000, 0) == (1.0, "bytes")
    assert chip_smoke.bound(0, 67_000_000_000) == (1.0, "operations")
    assert chip_smoke.bound(10, 10**12)[1] == "operations"
    from lzfse_rust_tpu_torch import TorchDecoder
    from lzfse_rust_tpu_torch.utils import corpus
    pairs = corpus.small_batch(seed=5, n_fse=3, lo=6_000, hi=12_000)
    lit, lmd = TorchDecoder("cpu").kernel_args([c for _, c in pairs])
    for name, fn, args in (("decode_literals", K.decode_literals, lit),
                           ("decode_lmds", K.decode_lmds, lmd)):
        outs = fn(**args)
        n_bytes, n_ops = chip_smoke.codec_work(name, args, outs)
        small = sum(v.numel() * 4 for k, v in args.items()
                    if k != "words" and torch.is_tensor(v))
        words = int(args["word_len"].sum()) * 4
        assert n_bytes == small + words + sum(o.numel() * 4 for o in outs)
        lanes = 1 if name == "decode_literals" else 3
        assert n_ops == chip_smoke.OPS_PER_SYMBOL * lanes * int(args["num"].sum())
        assert chip_smoke.longest_steps(name, args) == (
            (int(args["num"].max()) + 3) // 4 if lanes == 1
            else int(args["num"].max()))


def test_out_offsets():
    off, total = K.out_offsets([3, 0, 5, 1])
    assert off.tolist() == [0, 3, 3, 8] and total == 9
    assert K.literal_counts([0, 1, 4, 5]).tolist() == [0, 1, 1, 2]


def test_serving_batch_follows_snappy_mix():
    from lzfse_rust_tpu_torch.utils import corpus
    sizes = {k: sum(v.values()) for k, v in corpus.SNAPPY_BYTES.items()}
    assert sum(sizes.values()) * 48 == 141_241_872   # bench.py's batch
    assert corpus.MIX == pytest.approx(
        [sizes[k] / sum(sizes.values()) for k in corpus.KINDS])
    pairs = corpus.serving_batch(seed=3, min_bytes=2 << 20)
    assert pairs == corpus.serving_batch(seed=3, min_bytes=2 << 20)
    raws = [r for r, _ in pairs]
    assert sum(map(len, raws)) >= 2 << 20
    assert len(set(raws)) == len(raws) - 1    # two empty inputs, else distinct
    assert {c[:4] for _, c in pairs} == {b"bvx2", b"bvxn", b"bvx-", b"bvx$"}
    big = [r for r in raws if len(r) >= 16 << 10]
    assert big and all(len(r) <= 4 << 20 for r in big)
