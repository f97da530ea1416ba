"""ctypes bindings of the CUDA kernel library (``csrc/*.cu``).

The library is built by ``runtime/build.py`` and loaded on first use, never
at import: importing this module needs neither ``nvcc`` nor a card. Each
entry point has its own argument list: pointers and the stream are
``c_void_p`` (Python ints from ``tensor.data_ptr()`` and
``stream.cuda_stream``), counts ``c_int`` and buffer lengths
``c_longlong``.
Each entry point returns ``cudaGetLastError()``; ``check`` raises when it
is not 0.
"""

from __future__ import annotations

import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# entry point -> argument types
_ENTRY_POINTS = {
    # 12 pointers, nb, n_words, n_out, stream (csrc/fse_decode.cu)
    "lzt_decode_literals": [_P] * 12 + [_I, _L, _L, _P],
    "lzt_decode_lmds": [_P] * 12 + [_I, _L, _L, _P],
    # tables, rows, num, order, 3 outputs; nb, n_cols, stream
    # (csrc/fse_encode.cu)
    "lzt_encode_literals": [_P] * 7 + [_I, _I, _P],
    "lzt_encode_lmds": [_P] * 10 + [_I, _I, _P],
    # pads, n_reals, los, his, orders, oks, ticket, status, 4 outputs; nb,
    # n, vn, stream (csrc/match_find.cu)
    "lzt_match_rows": [_P] * 12 + [_I, _I, _I, _P],
    # attrs (3 ints)
    "lzt_match_rows_attrs": [_P],
    # literals, lit_off, rows, row_off, n_raw, out_off, span_end, lit_end,
    # row_start, root, tile_open, counts, out, ok; nb, n_rows, n_out,
    # n_lits, rounds, stream (csrc/lz_rebuild.cu)
    "lzt_lz_rebuild": [_P] * 14 + [_I] * 5 + [_P],
    # kernel, attrs (3 ints)
    "lzt_lz_rebuild_attrs": [_I, _P],
    # body; tab, chunk, x, out; n_rows, n_steps, stream (csrc/probes.cu)
    "lzt_probe_step": [_I] + [_P] * 4 + [_I, _I, _P],
    # body -> 1 table in shared memory, 0 in device memory, -1 unknown
    "lzt_probe_step_shared": [_I],
    # body; tab, x, out; n_steps, stream
    "lzt_probe_chain": [_I] + [_P] * 3 + [_I, _P],
    "lzt_probe_tput": [_I] + [_P] * 3 + [_I, _P],
}

_LIB = None


class CudaError(RuntimeError):
    """A kernel launch was refused or a kernel failed."""


def load(path) -> ctypes.CDLL:
    """Load a kernel library file and declare its entry points."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(handle, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    handle.lzt_error_string.restype = ctypes.c_char_p
    handle.lzt_error_string.argtypes = [ctypes.c_int]
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        from .build import build_kernels
        _LIB = load(build_kernels())
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise ``CudaError`` for a non-zero ``cudaGetLastError()`` code."""
    if rc != 0:
        msg = lib().lzt_error_string(rc).decode(errors="replace")
        raise CudaError(f"{what}: CUDA error {rc}: {msg}")
