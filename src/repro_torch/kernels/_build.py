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
through.  B6, the packed-weight decode, is a part of the GEMM and conv
kernels (``csrc/pack_common.cuh``): a launch of one of them on packed
planes also counts one under ``LAUNCHES["unpack_block"]``.  A bf16 basic
OS launch of B1 takes one of its two tensor-core tiles
(``csrc/gemm_tc.cuh``), an int8 or packed one one of its two integer
tensor-core tiles (``csrc/gemm_tc_i8.cuh``), and B9's basic OS launch one
of its two binary tensor-core tiles (``csrc/binary_mm.cu``), an int8,
packed or bf16 launch of B8 its tensor-core tile or walk
(``csrc/conv_tc.cuh``); a bf16 launch
of B1's residencies, B4, B5a or B5b over a sweep of two tiles or more
takes the cluster walk of ``csrc/gemm_cluster.cuh``, and a bf16 launch of
B7 its cluster kernel; the entry point reports the tile it took, which
also counts one under its name (``TILE_LIBRARIES``).  A launch of B2 or
B7 over int8 K/V also counts one under its ``I8KV_LAUNCHES`` key, and a
launch of B3 at a GQA group over 8 (its 16-warp kernel) one under
``PAGED_G16``, and a launch of B2 that writes its rows' statistics one
under ``FLASH_LSE``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
HEADERS = ("common.cuh", "attention_common.cuh", "conv_tc.cuh",
           "flash_tc.cuh", "flash_tc_step.cuh", "gemm_common.cuh",
           "gemm_cluster.cuh", "gemm_tc.cuh", "gemm_tc_i8.cuh",
           "mma_common.cuh", "pack_common.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# The GEMM, conv and binary kernels contract no multiply-add but their
# explicit fmaf, so every dataflow rounds each output element the same
# (csrc/gemm_common.cuh) and the epilogues round as eager PyTorch does.
GEMM_FLAGS = ("-fmad=false",)
NO_FMAD = ("matmul_", "conv2d", "binary_mm")
# Libraries compiled as PARTS[name] units with -DREPRO_PART=p (each defines
# some of the library's instantiations) plus one unit with its entry point.
PARTS = {"matmul_os": 9, "matmul_rmw": 8, "matmul_is_stripe": 5, "conv2d": 5}

# Element-type codes of the C interfaces (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int32: 3}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel library's entry point (csrc/<name>.cu); the
# GEMMs' common head ends with the packed weight's bits, bit plane and
# outlier sidecar.
_GEMM = (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P,
         _I)
SIGNATURES = {
    "matmul_os": _GEMM + (_I, _I, _P, _P),
    "matmul_rmw": _GEMM + (_I, _I, _I, _P, _P),
    "matmul_ws_stripe": _GEMM + (_P, _P),
    "matmul_is_stripe": _GEMM + (_I, _P, _P),
    "flash_attention": (_P,) * 7 + (_I,) * 8 + (_P, _I, _I, _I, _F, _P),
    "kv_stationary": (_P,) * 8 + (_I,) * 8 + (_P, _I, _I, _I, _F, _P, _P),
    "paged_attention": (_P,) * 9 + (_I,) * 9 + (_F, _I, _P),
    "conv2d": (_P, _P, _P) + (_I,) * 10 + (_P, _I, _P, _I, _P, _I, _P, _P,
                                           _P, _I, _I, _P, _I, _P, _I, _P,
                                           _P),
    "binary_mm": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I,
                  _P, _P),
}

# B6 decodes packed planes inside these libraries' kernels.
PACKED_DECODE = "unpack_block"
# B1's tiles, compiled into the matmul_os library: the basic OS tiles,
# bf16, then int8 (an int8 or a packed B), then the cluster walk of its
# residencies; a launch reports TILES[code - 1], or 0 for the walk
# (csrc/gemm_common.cuh TileCode).
TILES = ("matmul_os_prefill", "matmul_os_decode", "matmul_os_i8_prefill",
         "matmul_os_i8_decode", "matmul_os_cluster")
# B4's, B5a's and B5b's cluster walks (csrc/gemm_cluster.cuh), code 1 of
# theirs; B7's bf16 cluster kernel (csrc/kv_stationary.cu), code 1 of its.
RMW_TILES = ("matmul_rmw_cluster",)
WS_STRIPE_TILES = ("matmul_ws_stripe_cluster",)
IS_STRIPE_TILES = ("matmul_is_stripe_cluster",)
KV_TILES = ("kv_stationary_cluster",)
# B9's basic OS tiles on the binary tensor cores (csrc/binary_mm.cu
# TileCode), the same way.
BINARY_TILES = ("binary_mm_prefill", "binary_mm_decode")
# B8's int8 (and packed) and bf16 launches on the tensor cores
# (csrc/conv_tc.cuh TileCode): the OS tile, the WS and the IS walks; the
# f32 walk reports 0.
CONV_TILES = ("conv2d_os_i8", "conv2d_os_bf16", "conv2d_ws_i8",
              "conv2d_is_i8", "conv2d_ws_bf16", "conv2d_is_bf16")
# B2's and B7's launches over int8 K/V (the int8 KV cache), each counted
# beside the library's own count (and, for B7's bf16 path, its cluster
# tile's): under bf16 queries, then under float32 queries.
I8KV_LAUNCHES = ("flash_attention_i8kv", "kv_stationary_cluster_i8kv",
                 "flash_attention_f32_i8kv", "kv_stationary_f32_i8kv")
# B3's launches on its 16-warp kernel (a GQA group of 9 to 16), counted
# beside the library's own count.
PAGED_G16 = "paged_attention_g16"
# B2's launches that also write each row's statistic (the cache attention
# split over a mesh's keys), counted beside the library's own count (and an
# int8 launch's ``I8KV_LAUNCHES`` key).
FLASH_LSE = "flash_attention_lse"
# The libraries whose entry point reports the tile a launch took, with the
# tiles by code.
TILE_LIBRARIES = {"matmul_os": TILES, "matmul_rmw": RMW_TILES,
                  "matmul_ws_stripe": WS_STRIPE_TILES,
                  "matmul_is_stripe": IS_STRIPE_TILES,
                  "kv_stationary": KV_TILES, "binary_mm": BINARY_TILES,
                  "conv2d": CONV_TILES}
# What the last such launch took (csrc/gemm_common.cuh gemm::Took, also
# B7's and B8's report; csrc/binary_mm.cu bin::Took): the tile code, its
# shared memory bytes, its CTAs and (a cluster walk) the CTAs of a cluster,
# or (B8) the split of k.
_TOOK = (ctypes.c_int * 4)()
LAUNCHES: Dict[str, int] = {name: 0 for name in
                            (*SIGNATURES, PACKED_DECODE, *I8KV_LAUNCHES,
                             PAGED_G16, FLASH_LSE,
                             *(t for tiles in TILE_LIBRARIES.values()
                               for t in tiles))}
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


def launch(name: str, *args, packed: bool = False,
           also: Union[None, str, Tuple[str, ...]] = None
           ) -> Optional[tuple]:
    """Call kernel ``name``'s entry point on the current CUDA stream,
    count the launch (and, when it decodes ``packed`` planes, B6's; and
    under each name of ``also``, of ``I8KV_LAUNCHES``, ``PAGED_G16`` and
    ``FLASH_LSE``) and raise
    if it was refused.  A launch of a ``TILE_LIBRARIES`` entry that
    took one of its tiles (B1's, B4's, B5a's, B5b's, B7's, B9's) counts
    that tile too and returns (tile, shared memory bytes, CTAs) as the
    kernel reported them, with the cluster size (a cluster walk) or the
    split of k (B8's tiles) after them; every other launch returns
    None."""
    lib = library(name)
    stream = torch.cuda.current_stream().cuda_stream
    took = (_TOOK,) if name in TILE_LIBRARIES else ()
    for i in range(len(_TOOK)):
        _TOOK[i] = 0
    rc = getattr(lib, name)(*args, *took, stream)
    if rc != 0:
        raise KernelError(
            f"{name} kernel launch failed: "
            f"{lib.repro_error_string(rc).decode()} (code {rc})")
    LAUNCHES[name] += 1
    if packed:
        LAUNCHES[PACKED_DECODE] += 1
    for key in (also,) if isinstance(also, str) else also or ():
        LAUNCHES[key] += 1
    if not took or not _TOOK[0]:
        return None
    tile = TILE_LIBRARIES[name][_TOOK[0] - 1]
    LAUNCHES[tile] += 1
    return (tile, _TOOK[1], _TOOK[2]) + ((_TOOK[3],) if _TOOK[3] else ())


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"CUDA kernels take float32, bfloat16, int8 or "
                        f"int32 tensors, got {t.dtype}") from None


def refuse_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """A launch writes into a fresh tensor that carries no gradient, so
    under grad an operand that requires one raises here: B1 and B2 carry
    theirs through ``kernels/autograd.py`` (whose launches run with grad
    disabled); no other kernel has a backward (the binary and packed
    weights are integer planes, B3 serves decode, B8 the stubbed conv
    frontend), and a gradient is never dropped in silence."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{kernel}: an operand requires grad, and this kernel has no "
            f"backward; gradients flow through ops.matmul_fused (float "
            f"operands) and ops.attention (float K/V) only")


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
