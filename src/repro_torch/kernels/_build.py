"""Build, load and call the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object file,
all of them at once, in parallel, and the objects are linked into one shared
library with a plain C interface, under ``build/repro_torch/`` at the
repository root, at first use, and loaded with ``ctypes``.  The library's
file name carries a hash of the sources and the flags, so an edited source
rebuilds and a built one is reused.  Nothing here runs at import time: the
CPU tests import every module of the package on a host with no ``nvcc``.

Every pointer and the stream go to C as ``ctypes.c_void_p``; each C entry
returns ``cudaGetLastError()`` and :func:`launch` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "dsa_kernels.cu", CSRC / "flash_attention.cu",
           CSRC / "decode_attention.cu", CSRC / "mla_decode.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the CUDA toolkit's default install
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "dsa_memcpy_words": (_P, _P, _LL, _I, _P),
    "dsa_batch_copy_pages": (_P, _P, _P, _P, _I, _LL, _LL, _LL, _P),
    "dsa_crc32_chunk_states": (_P, _P, _P, _I, _LL, _P),
    "dsa_copy_crc_words": (_P, _P, _P, _P, _I, _LL, _P),
    "dsa_crc_fold": (_P, _P, _P, _I, _I, _P),
    "dsa_fill_words": (_P, _LL, _I, _U, _U, _U, _U, _P),
    "dsa_compare_words": (_P, _P, _LL, _P, _P, _P, _P),
    "dsa_compare_pattern_words": (_P, _LL, _U, _U, _U, _U, _P, _P, _P, _P),
    "dsa_fill_verify_words": (_P, _LL, _U, _U, _U, _U, _P, _P, _P, _P),
    "dsa_dualcast_words": (_P, _P, _P, _LL, _P),
    "dsa_delta_count": (_P, _P, _LL, _P, _P, _I, _P),
    "dsa_delta_write": (_P, _LL, _P, _P, _P, _I, _LL, _P, _P, _P, _P, _P),
    "dsa_delta_apply_words": (_P, _P, _LL, _P, _P, _LL, _P, _P, _P),
    "dsa_flash_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "dsa_flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "dsa_decode_attention": (_P,) * 11 + (_I,) * 7 + (_LL,) * 7 + (_F, _I, _I, _P),
    "dsa_mla_decode": (_P,) * 8 + (_I,) * 4 + (_LL,) * 4 + (_F, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (``-Xptxas=-v``: registers, shared memory and
#: spills of every kernel) and how long it took; empty when the library
#: was found already built
build_log = ""
build_seconds = 0.0


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH "
                       "to build the repro_torch CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdsa_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands at once; raise naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n"
                               f"{' '.join(c)}\n{log}")
    return "".join(logs)


def _build() -> Path:
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        # one nvcc for each source, all started together, then one link
        build_log = _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                              for src, o in zip(SOURCES, objs)])
        build_log += _run_all([[nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        build_seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.dsa_error_string.argtypes = [ctypes.c_int]
            lib.dsa_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch was refused."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.dsa_error_string(err).decode()}")


def stream(t: torch.Tensor) -> int:
    """Handle of the current stream of ``t``'s device (where launches go)."""
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------- launch counts
_count_lock = threading.Lock()


def count(wrapper) -> None:
    """Add one to ``wrapper.launches`` (PE worker threads launch
    concurrently, so the increment takes a lock)."""
    with _count_lock:
        wrapper.launches += 1


# --------------------------------------------------------------------------- argument checks
def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise on what the kernels do not take: another dtype or rank, a
    non-contiguous tensor, or a device that is neither the CPU (plain
    version) nor CUDA (kernel)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {t.device} are not supported; "
                         f"the kernel takes CUDA tensors, the plain version "
                         f"CPU tensors")


def same_device(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
    return dev
