"""Error model for the TPU-native LZFSE framework.

Decoding is total: any byte sequence yields either a decoded buffer or a typed
DecodeError — never a crash or hang. Mirrors the error taxonomy of the reference
(src/error/mod.rs:40-61, src/fse/error_kind.rs, src/vn/error_kind.rs).
"""

from __future__ import annotations


class LzfseError(Exception):
    """Base class for all framework errors."""


class DecodeError(LzfseError):
    """Malformed or malicious compressed input."""


class BadBlock(DecodeError):
    def __init__(self, magic: int):
        super().__init__(f"bad block magic: 0x{magic:08X}")
        self.magic = magic


class BadBitStream(DecodeError):
    pass


class BadReaderState(DecodeError):
    pass


class BufferOverflow(DecodeError):
    pass


class PayloadOverflow(DecodeError):
    pass


class PayloadUnderflow(DecodeError):
    pass


class FseError(DecodeError):
    """FSE (tANS) block errors. `kind` mirrors FseErrorKind variants."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"fse: {kind}{(': ' + detail) if detail else ''}")
        self.kind = kind


class VnError(DecodeError):
    """LZVN block errors. `kind` mirrors VnErrorKind variants."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"vn: {kind}{(': ' + detail) if detail else ''}")
        self.kind = kind
