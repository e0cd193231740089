"""Host rehearsal of the port's CUDA kernels, shared by the `*_host.py`
tests: a kernel source's own code built with g++ and called through ctypes.

The device functions compile as host C++ (`__device__` defined away; the
PTX field ops and 16-byte loads take their C++ forms, the same words).  The
`__global__` kernels (from `#include <cuda_runtime.h>` to the `// ---- host
launchers ----` line) run whole: `run_grid` starts one `std::thread` per
CUDA thread of a block, `threadIdx`/`blockIdx` thread-local,
`__syncthreads()` a `std::barrier`, the blocks one after another.
`__ballot_sync` is a vote through a block-wide array between two barriers,
so a kernel must call it with the whole block; the bucket sort's other warp
intrinsics only compile here.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

from sirius_tpu_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"

PRELUDE = r"""
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
struct HostDim3 { unsigned x = 0, y = 0, z = 0; };
static thread_local HostDim3 threadIdx, blockIdx;
static HostDim3 blockDim, gridDim;
static std::barrier<>* host_barrier = nullptr;
static inline void __syncthreads() { host_barrier->arrive_and_wait(); }
static unsigned host_votes[1024];
static inline unsigned __ballot_sync(unsigned, bool pred) {
  host_votes[threadIdx.x] = pred;
  __syncthreads();
  const unsigned w0 = threadIdx.x & ~31u;
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i)
    if (host_votes[w0 + i]) m |= 1u << i;
  __syncthreads();
  return m;
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline void __syncwarp() {}
static inline unsigned __match_any_sync(unsigned, int) { return 0u; }
static inline int atomicAdd(int* p, int v) { const int o = *p; *p += v; return o; }

// Runs every block of a launch, one std::thread per CUDA thread.
template <class F>
static void run_grid(unsigned blocks, unsigned threads, F body) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    host_barrier = &bar;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : ts) th.join();
  }
}
"""


def host_source(name: str, shared: dict[str, str] | None = None, kernels: bool = True) -> str:
    """A kernel source as host C++: its device functions, then (`kernels`)
    its kernels, each `extern __shared__` declaration in `shared` replaced
    by its static array."""
    text = (CSRC / name).read_text()
    device, rest = text.split("#ifdef __CUDACC__", 1)
    if not kernels:
        return device
    body = rest.split("#include <cuda_runtime.h>", 1)[1].split("// ---- host launchers ----", 1)[0]
    for decl, static in (shared or {}).items():
        body = body.replace(decl, static)
    return device + body


def build(tmp_path_factory, name: str, source: str) -> ctypes.CDLL:
    """PRELUDE + source built with g++ into a shared library, loaded (the
    test skips where g++ is absent)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host rehearsal of the CUDA kernels")
    d = tmp_path_factory.mktemp(name)
    src = d / f"{name}.cpp"
    src.write_text(PRELUDE + source)
    so = d / f"lib{name}.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{CSRC}", "-o", str(so),
                           str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(so))
