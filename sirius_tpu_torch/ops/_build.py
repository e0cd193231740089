"""Build and load the CUDA kernels of `csrc/`.

The sources compile with `nvcc` for sm_90a, one process per source, all
started together, and link into one shared library with a plain C
interface, loaded with ctypes.  Nothing happens at import: the first
CUDA launch calls `library()`, which builds into `sirius_tpu_torch/_build/`
(git-ignored) under a name keyed by a hash of the sources and flags, so a
fresh checkout builds once and an unchanged tree never rebuilds: a second
process finds the library of the first and loads it without running nvcc
(`built_here()` says whether this process ran it).

Each C entry point takes the 17-word field constant block (p, R mod p,
-p^-1 mod 2^32) as a host pointer, device pointers as `c_void_p`, sizes as
64-bit ints, and the CUDA stream last; it returns the `cudaError_t` of the
launch, which `check` raises on.  Every wrapper calls its entries through
`launch`, which makes the operands' device current for the call: a ctypes
launch runs on the calling thread's current device, so without it a kernel
given the stream of `cuda:1` while `cuda:0` is current fails with an
invalid resource handle.  The entries that raise a kernel's dynamic shared
memory above 48 KB (`cudaFuncSetAttribute` in `msm_reduce_rolled` and
`col_ntt`) set it on every call, so on whichever device is current: each
device that launches them gets the attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sirius_madd": [P] * 9 + [LL, P],
    "sirius_madd_buckets": [P] * 7 + [LL, LL, I, I, I, P],
    "sirius_madd_attrs": [I, P],
    "sirius_msm_accumulate": [P] * 9 + [LL, P],
    "sirius_msm_bucket_count": [P] * 3 + [LL, I, LL, P],
    "sirius_msm_bucket_scatter": [P] * 8 + [LL, I, LL, LL, P],
    "sirius_msm_reduce": [P] * 8 + [LL, LL, P],
    "sirius_msm_reduce_rolled": [P] * 9 + [LL, LL, P],
    "sirius_msm_window_sums": [P] * 7 + [LL, I, I, P],
    "sirius_msm_horner": [P] * 7 + [I, I, I, I, P],
    "sirius_msm_attrs": [I, P],
    "sirius_col_ntt": [P] * 6 + [LL, LL, LL, P],
    "sirius_col_ntt_attrs": [I, P],
    "sirius_mul_rows": [P] * 4 + [LL] * 5 + [I, I, P],
    "sirius_addsub_rows": [P] * 4 + [LL] * 4 + [I, P],
    "sirius_mul_rows_attrs": [I, P],
    "sirius_raw_u32": [P] * 2 + [LL, I, I, P],
    "sirius_add_one": [P] * 2 + [LL, P],
    "sirius_lookup_insert": [P] * 2 + [LL, LL, P],
    "sirius_lookup_probe": [P] * 4 + [LL, LL, LL, P],
}
_BUILT_HERE = False
# launches by (C entry without its `sirius_` prefix, device): what a mesh ran where
device_launches: Counter = Counter()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _BUILT_HERE
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libsirius_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        srcs = sorted(SRC_DIR.glob("*.cu"))
        objs = [tmp.with_name(f"{tmp.stem}.{src.stem}.o") for src in srcs]
        try:
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True) for src, obj in zip(srcs, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            (BUILD_DIR / "ptxas.log").write_text("".join(logs))
            for src, proc, text in zip(srcs, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{text[-4000:]}")
            proc = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, so)
        _BUILT_HERE = True
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def built_here() -> bool:
    """True when this process ran nvcc (not when it loaded a cached build)."""
    return _BUILT_HERE


@lru_cache(maxsize=None)
def field_consts(field) -> ctypes.Array:
    """The 17-word constant block of a port `Field` (host memory; one a field,
    since every ring op on the card passes it)."""
    words = [*field.p_words, *field.one_mont_words, field.n0inv32]
    return (ctypes.c_uint32 * 17)(*words)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def launch(name: str, like: torch.Tensor, *args, counted_as: str | None = None) -> None:
    """Call the C entry `sirius_<name>` with `args` and the current stream of
    `like`'s device, with that device current; raise on a failed launch and
    count it in `device_launches` (under `counted_as` where a caller keeps
    its launches apart from the entry's)."""
    with torch.cuda.device(like.device):
        err = getattr(library(), f"sirius_{name}")(*args, stream_of(like))
    check(err, name)
    device_launches[(counted_as or name, str(like.device))] += 1


def require_cuda(*tensors: torch.Tensor, dtype: torch.dtype = torch.int64, contiguous: bool = True) -> None:
    """Validate kernel operands: one CUDA device, `dtype`, contiguous (unless
    the kernel reads them at a row stride)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.device.type != "cuda":
            raise ValueError(f"kernel operand on {t.device}, not a CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"kernel operand dtype {t.dtype}, expected {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def require_aligned(*tensors: torch.Tensor) -> None:
    """Operands a kernel reads in 16-byte vector loads (`fe_load_ro`)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operand not 16-byte aligned")
