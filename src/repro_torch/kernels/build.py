"""Build and bind the port's hand-written CUDA kernels.

All sources in `csrc/` are compiled by ONE `nvcc` call into a shared library
with a plain C interface (`rt_*` functions), loaded with `ctypes`.  The build
happens at first use, never at import, into `build/repro_torch_kernels/` at
the repository root; the library's file name carries a digest of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on anything but 0, so a refused launch
never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bitunpack.cu", "dict_decode.cu", "delta_decode.cu", "fused_scan.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each entry point, after its pointer/int arguments the stream
SIGNATURES = {
    "rt_bitunpack": (_P, _P, _I, _I),
    "rt_dict_decode": (_P, _P, _I, _P, _I, _I, _I),
    "rt_delta_decode": (_P, _P, _P, _I, _I),
    "rt_fused_scan": (_P, _I, _I, _P, _P, _I, _I),
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this exact source set has not been built yet;
    returns the shared library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if lib.exists():
        return lib
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*args, _P]
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point `name` on `device`'s current stream.  Tensors are
    passed as their data pointers, ints as C ints.  Raises RuntimeError with
    CUDA's message when the launch is refused."""
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*c_args, stream)
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


def check_packed(packed: torch.Tensor, k: int) -> int:
    """Validate a packed-block operand for a kernel; returns its block count.
    The kernels take the uint32 words as an int32 view of the same bits."""
    if not packed.is_cuda:
        raise ValueError(f"kernel operand must be a CUDA tensor, got {packed.device}")
    if packed.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 (a view of uint32), got {packed.dtype}")
    if not 1 <= k <= 32:
        raise ValueError(f"bit width k={k} outside 1..32")
    if packed.dim() != 3 or packed.shape[1] != k or packed.shape[2] != 128:
        raise ValueError(f"packed must be (nblocks, {k}, 128), got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.shape[0] > 2**31 - 1:
        raise ValueError("too many blocks for one launch")
    return int(packed.shape[0])
