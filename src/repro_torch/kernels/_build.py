"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds, not
minutes). Libraries are built at first use into ``kernels/_build/``
(listed in ``.gitignore``), named by a digest of their sources and
flags, so an edited source is never served from a stale build.
``build_all`` starts one ``nvcc`` per source at once; a GEMM library
with many template instantiations (``PARTS``) is compiled as several
translation units at once, its entry point and each part of its
instantiations, and linked. A build or launch that fails raises
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
HEADERS = ("common.cuh", "attention_common.cuh", "gemm_common.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# The GEMM, conv and binary kernels contract no multiply-add but their
# explicit fmaf, so every dataflow rounds each output element the same
# (csrc/gemm_common.cuh) and the epilogues round as eager PyTorch does.
GEMM_FLAGS = ("-fmad=false",)
NO_FMAD = ("matmul_", "conv2d", "binary_mm")
# Libraries compiled as PARTS[name] units with -DREPRO_PART=p (each defines
# some of the library's instantiations) plus one unit with its entry point.
PARTS = {"matmul_os": 4, "matmul_rmw": 4, "conv2d": 3}

# Element-type codes of the C interfaces (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int32: 3}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel library's entry point (csrc/<name>.cu).
_GEMM = (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P)
SIGNATURES = {
    "matmul_os": _GEMM + (_I, _I, _P),
    "matmul_rmw": _GEMM + (_I, _I, _I, _P),
    "matmul_ws_stripe": _GEMM + (_P,),
    "matmul_is_stripe": _GEMM + (_I, _P),
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                        _I, _I, _F, _P),
    "kv_stationary": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                      _I, _I, _I, _F, _P),
    "paged_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _I, _P),
    "conv2d": (_P, _P, _P) + (_I,) * 10 + (_P, _I, _P, _I, _P, _I, _P),
    "binary_mm": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I,
                  _P),
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


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + (GEMM_FLAGS if name.startswith(NO_FMAD) else ())


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    digest.update(str(PARTS.get(name, 0)).encode())
    for src in (f"{name}.cu",) + HEADERS:
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile_jobs(name: str, out: Path):
    """(command, output) of each nvcc run that builds library ``name``:
    one straight to the library, or one object per part and the entry
    point's object (linked afterwards)."""
    src = str(CSRC / f"{name}.cu")
    flags = nvcc_flags(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if name not in PARTS:
        return [([*flags, "-o", str(tmp), src], tmp)]
    obj_flags = [f for f in flags if f != "-shared"] + ["-c"]
    jobs = []
    for part in [None, *range(PARTS[name])]:
        obj = out.with_suffix(f".{'main' if part is None else part}."
                              f"{os.getpid()}.o")
        define = [] if part is None else [f"-DREPRO_PART={part}"]
        jobs.append(([*obj_flags, *define, "-o", str(obj), src], obj))
    return jobs


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, every translation unit of all of
    them started together.  Returns seconds spent per library built."""
    names = list(SIGNATURES if names is None else names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name, out in todo.items():
        procs[name] = [
            (subprocess.Popen([nvcc, *cmd], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True), target)
            for cmd, target in _compile_jobs(name, out)]
    seconds, failed = {}, []
    for name, jobs in procs.items():
        out = todo[name]
        logs, ok = [], True
        for proc, _ in jobs:
            log, _ = proc.communicate()
            logs.append(log)
            ok = ok and proc.returncode == 0
        targets = [target for _, target in jobs]
        if ok and name in PARTS:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc, *[f for f in nvcc_flags(name) if f != "-Xptxas=-v"],
                 "-o", str(tmp), *map(str, targets)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            ok = link.returncode == 0
            for obj in targets:
                obj.unlink(missing_ok=True)
            targets = [tmp]
        seconds[name] = time.monotonic() - t0
        BUILD_LOGS[name] = "".join(logs)
        if not ok:
            failed.append(f"{name}:\n{BUILD_LOGS[name]}")
            continue
        os.replace(targets[0], out)
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
        raise TypeError(f"CUDA kernels take float32, bfloat16, int8 or "
                        f"int32 tensors, got {t.dtype}") from None


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
