"""ECC codecs over 64-bit data words. The registry holds ``secded72`` (Hsiao
SECDED, the paper's built-in BRAM ECC); ``get(name)`` returns the cached
Codec instance."""

from repro_torch.codes import secded  # noqa: F401  (registers secded72)
from repro_torch.codes.base import (
    DEFAULT_CODEC,
    N_DATA,
    STATUS_CLEAN,
    STATUS_CORRECTED,
    STATUS_DETECTED,
    Codec,
    get,
    names,
)

__all__ = [
    "Codec",
    "DEFAULT_CODEC",
    "N_DATA",
    "STATUS_CLEAN",
    "STATUS_CORRECTED",
    "STATUS_DETECTED",
    "get",
    "names",
]
