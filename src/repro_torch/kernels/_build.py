"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries are built at first use into ``kernels/_build/`` (listed in
``.gitignore``), named by a digest of their sources and flags, so an
edited source is never served from a stale build.  ``build_all`` starts
one ``nvcc`` per source at once.  A build or launch that fails raises
``KernelError``, which the serving engine never absorbs: nothing falls
back to the plain PyTorch versions.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else, so a run can show which kernels it went
through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
HEADERS = ("common.cuh", "attention_common.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Element-type codes of the C interfaces (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel library's entry point (csrc/<name>.cu).
SIGNATURES = {
    "matmul_os": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P),
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                        _I, _I, _F, _P),
    "paged_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _I, _P),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
# ptxas resource report of each build of this process, by kernel.
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel library could not be built, or its launch was refused."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu",) + HEADERS:
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns seconds spent per library built."""
    names = list(SIGNATURES if names is None else names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = list(SIGNATURES[name])
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s entry point on the current CUDA stream,
    count the launch and raise if it was refused."""
    lib = library(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise KernelError(
            f"{name} kernel launch failed: "
            f"{lib.repro_error_string(rc).decode()} (code {rc})")
    LAUNCHES[name] += 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}") from None


def require_cuda(*tensors: Optional[torch.Tensor]) -> None:
    """Every tensor given lies on one CUDA device and is contiguous."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel operands must share one CUDA device, got "
                         f"{sorted(str(d) for d in devs)}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def require_aligned(*tensors: torch.Tensor) -> None:
    """The attention kernels load 16-byte vectors from each tensor's
    start (a fresh allocation always is; a view may not be)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("attention kernel operands must start on a "
                             "16-byte boundary")
