"""lzfse_rust_tpu_torch -- the LZFSE codec's serving decode and encode on PyTorch and CUDA.

A port of ``lzfse_rust_tpu`` (JAX on a TPU) to PyTorch with kernels written
by hand for the NVIDIA H100 (``sm_90a``). The JAX package stays beside it as
the reference. This package imports nothing of it: it keeps its own copies
of the host layers it needs (``base``, ``spec``, the native runtime's C++
source and ctypes wrapper, the codec models' host helpers), and never
imports JAX.

    from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
    outs = TorchDecoder("cuda").decode_many(containers)
    blobs = TorchEncoder("cuda").encode_many(raws)

Layout mirrors the reference: ``runtime/`` builds and binds the native
libraries, ``csrc/`` holds the CUDA sources, ``ops/`` the kernel wrappers
with their plain PyTorch versions, ``models/`` the decoder and the encoder,
``utils/`` the timing helpers and the seeded corpus.
"""

from .models.decoder import TorchDecoder
from .models.encoder import TorchEncoder

__all__ = ["TorchDecoder", "TorchEncoder"]
