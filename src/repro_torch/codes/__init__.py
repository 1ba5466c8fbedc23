"""ECC codecs over 64-bit data words, weakest to strongest:

  ``parity65``  1 check bit   detect-only
  ``secded72``  8 check bits  Hsiao SECDED, the paper's built-in BRAM ECC
  ``ileave88``  24 check bits 4-way interleaved SECDED, corrects bursts <= 4
  ``dected79``  15 check bits shortened extended BCH DEC-TED

``get(name)`` returns the cached Codec instance; ``names()`` lists the
registry in that order."""

# Import order fixes the registry order (weakest -> strongest).
from repro_torch.codes import parity, secded, interleaved, dected  # noqa: F401, I001
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
