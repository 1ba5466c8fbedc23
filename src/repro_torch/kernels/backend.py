"""Build, load and dispatch the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``. The
build runs on first use (or all at once through ``build()``, one ``nvcc``
per source, started together) and writes into ``kernels/build/``, a
directory git ignores; a library's file name carries a hash of its sources
and flags, so an edited source is rebuilt.

Dispatch is by tensor device: a wrapper takes its plain PyTorch version for
CPU tensors and launches its kernel for CUDA tensors; any other placement
raises. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = (
    "inject_scrub", "secded", "ecc_matmul", "paged_gather", "fault_inject", "fault_field",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}
BUILD_LOG: dict = {}  # source name -> nvcc output (ptxas register/smem report)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card. Raises
    when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless device='cpu' "
            "is passed"
        )
    return dev


def dispatch(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel) for tensors on one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device type {kind!r}")
    return kind


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. A copy to the card goes through pinned
    memory without blocking, so it does not wait for the queued device
    work (a plain copy from pageable memory synchronises the stream)."""
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns {name: seconds} of the builds it ran and
    raises with the compiler's output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                out,
            )
        seconds = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            os.replace(tmp, out)
            seconds[name] = time.perf_counter() - t0
        return seconds
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(t: torch.Tensor, dtype: torch.dtype, name: str, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check_planes(lo, hi, chk, mlo, mhi, mchk, check_dtype=torch.uint8) -> int:
    """Raise unless the three planes and their three masks are flat CUDA
    tensors of one length n (lo/hi int32, check ``check_dtype``, masks
    alike); returns n."""
    n = lo.numel()
    for t, dt, name in (
        (lo, torch.int32, "lo"), (hi, torch.int32, "hi"), (chk, check_dtype, "check"),
        (mlo, torch.int32, "mask_lo"), (mhi, torch.int32, "mask_hi"),
        (mchk, check_dtype, "mask_check"),
    ):
        check(t, dt, name, (n,))
    return n


class Kernel:
    """One exported C launcher. ``launches`` counts the launches it made; a
    launcher whose first argument names the codec (``by_codec``) also counts
    them per value of that argument in ``launches_by_codec``: the
    ``codec_key`` attribute of the ``Codec`` it came from (its kernel id, or
    its check-bit count for the fault field). A launch the runtime refused
    raises."""

    def __init__(self, source: str, symbol: str, argtypes: list, by_codec: bool = False,
                 codec_key: str = "kernel_id"):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.by_codec = by_codec
        self.codec_key = codec_key
        self.launches = 0
        self.launches_by_codec: dict = {}
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.launches_by_codec = {}

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._errstr = lib.cuda_error_string
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {rc} ({self._errstr(rc).decode()})"
            )
        self.launches += 1
        if self.by_codec:
            self.launches_by_codec[args[0]] = self.launches_by_codec.get(args[0], 0) + 1


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
U64 = ctypes.c_ulonglong
