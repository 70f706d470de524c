"""Build and bind the port's hand-written CUDA kernels.

The sources in `csrc/` are compiled into one shared library with a plain C
interface (`rt_*` functions), loaded with `ctypes`: one `nvcc` per source,
all started together, then one `nvcc` that links the objects.  The build
happens at first use, never at import, into `build/repro_torch_kernels/` at
the repository root; the library's file name carries a digest of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on anything but 0, so a refused launch
never passes silently.  A failed build, load or launch raises `KernelError`,
which the datapath service never mistakes for one request's own failure
(`DEVICE_ERRORS`, datapath/scheduler.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bitunpack.cu", "dict_decode.cu", "delta_decode.cu", "fused_scan.cu",
           "rle_decode.cu", "filter_compact.cu", "bloom_probe.cu", "agg_push.cu",
           "flash_attention.cu", "flash_attention_wgmma.cu")
HEADERS = ("common.cuh", "tma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each entry point, after its pointer/int/float arguments the stream
SIGNATURES = {
    "rt_bitunpack": (_P, _P, _I, _I),
    "rt_dict_decode": (_P, _P, _I, _P, _I, _I),
    "rt_delta_decode": (_P, _P, _P, _I, _I),
    "rt_fused_scan": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _I),
    "rt_rle_decode": (_P, _P, _P, _I, _I, _I),
    "rt_filter_compact": (_P, _P, _P, _P, _I),
    "rt_bloom_probe": (_P, _P, _I, _I, _P, _I),
    "rt_dict_decode_batch": (_P, _P, _I, _I, _P, _P, _P, _I, _I),
    "rt_fused_scan_batch": (_P, _P, _P, _P, _I, _I),
    "rt_grouped_agg": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I),
    "rt_fused_agg": (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I),
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I),
    "rt_flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F),
}

_lib: Optional[ctypes.CDLL] = None


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch: a fault of the card or
    of the port, never of one scan's input."""


# What the card itself raises: a kernel's own failure, and CUDA errors and
# out-of-memory raised by torch.  The service's per-request fault isolation
# re-raises these instead of parking them on a ticket.
DEVICE_ERRORS = tuple(t for t in (KernelError, getattr(torch, "AcceleratorError", None),
                                  torch.cuda.OutOfMemoryError) if t is not None)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its name, its CUDA source, the TPU kernel it
    replaces (file:line in `src/repro/`) and its launches since the last
    `reset()`.  A wrapper adds one to `launches` where it launches the
    kernel, and nowhere else."""

    name: str
    source: str
    replaces: str
    launches: int = 0

    def reset(self) -> int:
        """Zero the launch count; returns the value it had."""
        n, self.launches = self.launches, 0
        return n


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
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


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
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in compiles]
        for cmd, proc in zip(compiles, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                for p in procs:
                    p.kill()
                    p.wait()
                raise KernelError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        so = str(Path(tmp) / lib.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
        os.replace(so, lib)  # atomic: concurrent builders never see a partial file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load the kernel library {path}: {e}") from e
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
    passed as their data pointers, floats as C floats, ints as C ints.
    Raises KernelError with CUDA's message when the launch is refused."""
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a if isinstance(a, float)
              else int(a) for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*c_args, stream)
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise KernelError(f"{name} failed: CUDA error {rc} ({msg})")


def check_operand(t: torch.Tensor, name: str, dtypes, shape, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of one of `dtypes` with
    `shape` (None matches any size), on `device` when one is given."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the other operands on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and d != s for d, s in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dim() and t.shape[0] > 2**31 - 1:
        raise ValueError(f"{name}: too many blocks for one launch")


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """`t`, or a copy of it when its data does not start on an `nbytes`
    boundary (a view at an odd offset; torch's own allocations are aligned)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check_packed(packed: torch.Tensor, k: int) -> int:
    """Validate a packed-block operand for a kernel; returns its block count.
    The kernels take the uint32 words as an int32 view of the same bits."""
    if not 1 <= k <= 32:
        raise ValueError(f"bit width k={k} outside 1..32")
    check_operand(packed, "packed words (an int32 view of uint32)", (torch.int32,), (None, k, 128))
    return int(packed.shape[0])
