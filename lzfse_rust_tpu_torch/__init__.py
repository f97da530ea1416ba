"""lzfse_rust_tpu_torch -- the LZFSE codec on PyTorch and CUDA.

A port of ``lzfse_rust_tpu`` (JAX on a TPU) to PyTorch with kernels written
by hand for the NVIDIA H100 (``sm_90a``). The JAX package stays beside it as
the reference. This package imports nothing of it: it keeps its own copies
of the host layers it needs (``base``, ``spec``, the native runtime's C++
source and ctypes wrapper, the codec models' host helpers), and never
imports JAX.

Public API, the JAX package's names (``api.py``; the batch calls on the
card, the other engines on the host in the native runtime, which is built
from the checkout at first use):

    encode_bytes(data)          -> compressed container bytes
    decode_bytes(data)          -> decompressed bytes
    encode_many / decode_many   -- a batch on the card (``device="cpu"``:
                                   a host thread pool)
    LzfseEncoder / LzfseDecoder -- reusable engine objects (buffer API)
    LzfseRingEncoder / LzfseRingDecoder -- streaming engines
    LzfseWriter / LzfseReader   -- push/pull file-object adapters
    probe(data)                 -> (n_payload_bytes, n_raw_bytes) w/o decode

Batched engines on the card:

    from lzfse_rust_tpu_torch import TorchDecoder, TorchEncoder
    outs = TorchDecoder("cuda").decode_many(containers)
    blobs = TorchEncoder("cuda").encode_many(raws)

The command-line tool is ``python3 -m lzfse_rust_tpu_torch.cli``.

Layout mirrors the reference: ``runtime/`` builds and binds the native
libraries, ``csrc/`` holds the CUDA sources, ``ops/`` the kernel wrappers
with their plain PyTorch versions, ``models/`` the decoder and the encoder,
``parallel/`` several devices, ``utils/`` the timing helpers and span
recorder, the engines' host buffers and the seeded corpus, ``tools/`` the
measurement tools.
"""

from .api import (LzfseDecoder, LzfseEncoder, LzfseReader, LzfseReaderBytes,
                  LzfseRingDecoder, LzfseRingEncoder, LzfseWriter,
                  LzfseWriterBytes, decode_bytes, decode_many, encode_bytes,
                  encode_many, probe)
from .base.errors import (BadBitStream, BadBlock, DecodeError, FseError,
                          LzfseError, PayloadOverflow, PayloadUnderflow,
                          VnError)
from .models.decoder import TorchDecoder
from .models.encoder import TorchEncoder

__version__ = "0.1.0"

__all__ = [
    "encode_bytes", "decode_bytes", "encode_many", "decode_many", "probe",
    "LzfseEncoder", "LzfseDecoder", "LzfseRingEncoder", "LzfseRingDecoder",
    "LzfseWriter", "LzfseReader", "LzfseReaderBytes", "LzfseWriterBytes",
    "LzfseError", "DecodeError", "BadBlock", "BadBitStream",
    "PayloadOverflow", "PayloadUnderflow", "FseError", "VnError",
    "TorchDecoder", "TorchEncoder",
]
