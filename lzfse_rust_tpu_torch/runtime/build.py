"""Build the port's native libraries from the sources in the checkout.

Three shared libraries, each compiled at first use into ``build/`` at the
repository root (listed in ``.gitignore``) and rebuilt only when the hash
of its sources, flags and target changes:

* ``build/liblzfse_torch_kernels.so`` -- the hand-written CUDA kernels of
  ``lzfse_rust_tpu_torch/csrc/*.cu``, compiled by ``nvcc`` for ``sm_90a``
  (one process per source, all started together, then one link) with a
  plain C interface and loaded with ``ctypes`` (``cuda_lib.py``).
* ``build/libtpulzfse.so`` -- the native host runtime, compiled from the
  port's own copy of its source, ``runtime/src/tpulzfse.cpp`` (the JAX
  package's, line for line, comments aside), with the flags of that package's
  ``runtime/build.sh``, and loaded into the port's own ``runtime/native.py``
  (a copy of the JAX package's ctypes wrapper). It is built on the host
  that runs it, since ``-march=native`` code may hold instructions another
  host lacks; no prebuilt library is ever loaded.
* ``build/libpyobjects.so`` -- the decoder's per-container work on Python
  objects (``runtime/src/pyobjects.c``: the sources' buffer addresses and
  lengths, the output bytes objects), compiled by ``gcc`` against the
  running interpreter's ``Python.h`` and loaded with ``ctypes.PyDLL``,
  which keeps the interpreter lock held through each call. Only the
  decoder needs it, and it is built at its first use.

A failed build raises ``BuildError`` carrying the compiler's stderr.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BUILD_DIR = ROOT / "build"
CSRC = PKG / "csrc"
NATIVE_SRC = PKG / "runtime" / "src" / "tpulzfse.cpp"
OBJECTS_SRC = PKG / "runtime" / "src" / "pyobjects.c"

# each source compiles alone (``-c``), all at once; one link joins them:
# 9.13 s against 12.01 s for one nvcc of all sources (same flags, mean of
# three each, H100 80GB HBM3 host, 8 cores)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
NVCC_LINK = ("-shared", "-Xcompiler", "-fPIC")
# the JAX package's runtime/build.sh, release build
NATIVE_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                "-pthread")
NATIVE_LINK = ("-shared", "-pthread")
OBJECTS_FLAGS = ("-O2", "-fPIC", "-std=c11", "-Wall")


class BuildError(RuntimeError):
    """A compiler was missing or refused a source."""


def _cpu_fingerprint() -> str:
    """The host CPU's feature flags: a ``-march=native`` build is only
    valid on a CPU with the same flags."""
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags"):
                return line
    except OSError:
        pass
    return os.uname().machine


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found (neither on PATH nor under "
                     "/usr/local/cuda/bin): the CUDA kernels cannot be built")


@contextlib.contextmanager
def _locked():
    """Serialise builds across processes (parallel test workers)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _run_all(cmds: list[list[str]], what: str) -> None:
    """Start every command at once and wait for all; raise ``BuildError``
    with the stderr of each that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    errors = []
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"(exit {proc.returncode}):\n{err}")
    if errors:
        raise BuildError(f"build of {what} failed " + "\n".join(errors))


def _build(out: pathlib.Path, compile_cmd: list[str], link_cmd: list[str],
           sources: list[pathlib.Path], salt: str) -> pathlib.Path:
    """Compile each source alone (``compile_cmd + [-c, -o, obj, src]``),
    all started together, then join the objects (``link_cmd + [-o, tmp] +
    objs``), unless ``out`` is current.

    The hash of the commands, the sources' contents and ``salt`` is kept
    beside the library; a mismatch rebuilds. The library is written under
    a temporary name and renamed into place, so a process that already
    mapped the old file keeps a valid mapping."""
    h = hashlib.sha256("\0".join(compile_cmd + link_cmd + [salt]).encode())
    for src in sources:
        h.update(src.read_bytes())
    key = h.hexdigest()
    stamp = out.with_name(out.name + ".sha256")
    with _locked():
        if out.exists() and stamp.exists() and stamp.read_text() == key:
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{i}.{s.stem}.o")
                for i, s in enumerate(sources)]
        try:
            _run_all([compile_cmd + ["-c", "-o", str(o), str(s)]
                      for o, s in zip(objs, sources)], out.name)
            _run_all([link_cmd + ["-o", str(tmp)] + [str(o) for o in objs]],
                     out.name)
        except BuildError:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, out)
        stamp.write_text(key)
    return out


def kernel_library(out: pathlib.Path, sources) -> pathlib.Path:
    """Compile CUDA ``sources`` (one ``nvcc`` each, in parallel) into the
    shared library ``out``."""
    nvcc = _nvcc()
    return _build(out, [nvcc, *NVCC_FLAGS], [nvcc, *NVCC_LINK],
                  list(sources), "")


def build_kernels() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into ``build/liblzfse_torch_kernels.so``."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise BuildError(f"no CUDA sources under {CSRC}")
    return kernel_library(BUILD_DIR / "liblzfse_torch_kernels.so", sources)


def build_native() -> pathlib.Path:
    """Compile the native host runtime into ``build/libtpulzfse.so``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise BuildError("g++ not found: the native runtime cannot be built")
    return _build(BUILD_DIR / "libtpulzfse.so", [cxx, *NATIVE_FLAGS],
                  [cxx, *NATIVE_LINK], [NATIVE_SRC], _cpu_fingerprint())


def build_objects() -> pathlib.Path:
    """Compile ``runtime/src/pyobjects.c`` against this interpreter's
    headers into ``build/libpyobjects.so``."""
    cc = shutil.which("gcc")
    if cc is None:
        raise BuildError("gcc not found: the decoder's object helpers "
                         "cannot be built")
    include = sysconfig.get_paths()["include"]
    if not (pathlib.Path(include) / "Python.h").exists():
        raise BuildError(f"Python.h not found under {include}: the "
                         f"decoder's object helpers cannot be built")
    return _build(BUILD_DIR / "libpyobjects.so",
                  [cc, *OBJECTS_FLAGS, f"-I{include}"], [cc, "-shared"],
                  [OBJECTS_SRC], sys.version)


def _load(so: pathlib.Path, loader):
    try:
        return loader(str(so))
    except OSError as exc:
        raise BuildError(f"cannot load {so}: {exc}") from exc


def load_objects():
    """``build/libpyobjects.so``, built if it is not current and loaded
    with ``ctypes.PyDLL``. ``runtime.native`` calls this on the first use
    of the functions it holds; raises ``BuildError`` when it cannot be
    built or loaded."""
    return _load(build_objects(), ctypes.PyDLL)


def native_runtime():
    """The port's ``runtime.native`` module, running on the library built
    here. Builds and installs it on first call; raises ``BuildError`` when
    it cannot be built or loaded. ``libpyobjects.so`` is built later, on
    the first call that needs it (``load_objects``)."""
    from . import native
    so = build_native()
    if native._LIB is None or getattr(native._LIB, "_name", None) != str(so):
        lib = _load(so, ctypes.CDLL)
        native._configure(lib)
        native._LIB = lib
        native._TRIED = True
    return native
