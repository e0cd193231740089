"""Host rehearsal of S1 `msm_reduce_rolled` (`csrc/msm.cu`) and S3's chains
(`csrc/microbench.cu`): the kernels' own code, built with g++ and run on the
CPU through ctypes (`host_kernels.py`: one `std::thread` per CUDA thread,
barriers and ballots and all), against the plain torch twins.  S1 runs the
launches its wrapper plans (`msm_kernels.rolled_passes`), so the pieces,
the pair lists and the passes are checked here; only the PTX asm is left
to the card's checks (`tests/test_torch_gpu.py`).  Skipped where g++ is
absent.
"""

import ctypes

import numpy as np
import pytest
import torch
from host_kernels import build, host_source

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.ops import _build
from sirius_tpu_torch.ops import microbench as mb
from sirius_tpu_torch.ops import msm_kernels as mk

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

LAUNCHER = r"""
// sirius_msm_reduce_rolled's launch.
extern "C" void host_msm_reduce_rolled(const uint32_t* consts, const long long* seg_off, const long long* piece_off,
                                       const long long* px, const long long* py, const long long* pz, long long* ox,
                                       long long* oy, long long* oz, long long n_seg, long long n_parts) {
  long long blocks = (n_parts + ROLLED_SPAN - 1) / ROLLED_SPAN;
  if (blocks < 1) blocks = 1;
  const FieldConst fc = make_field_const(consts);
  run_grid((unsigned)blocks, ROLLED_THREADS, [=] {
    msm_reduce_rolled_kernel(fc, seg_off, piece_off, px, py, pz, ox, oy, oz, n_seg);
  });
}

// S3's chains on n values, as the kernel runs them: groups of 4, the tail one by one.
extern "C" void host_raw_u32(const uint32_t* a, uint32_t* out, long long n, int op, int reps) {
  for (long long i = 0; i + 4 <= n; i += 4) {
    if (op == 0 && reps == RAW_UNROLL) raw_u32_quad<0, true>(out + i, a + i, reps);
    else if (op == 0) raw_u32_quad<0, false>(out + i, a + i, reps);
    else if (reps == RAW_UNROLL) raw_u32_quad<1, true>(out + i, a + i, reps);
    else raw_u32_quad<1, false>(out + i, a + i, reps);
  }
  for (long long i = n / 4 * 4; i < n; ++i)
    out[i] = op == 0 ? (reps == RAW_UNROLL ? raw_u32_one<0, true>(a[i], reps) : raw_u32_one<0, false>(a[i], reps))
                     : (reps == RAW_UNROLL ? raw_u32_one<1, true>(a[i], reps) : raw_u32_one<1, false>(a[i], reps));
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    shared = {"extern __shared__ Pt totals[];": "static Pt totals[512];",
              "extern __shared__ __align__(16) unsigned char rolled_smem[];":
              "alignas(16) static unsigned char rolled_smem[sizeof(RolledSmem)];"}
    lib = build(tmp_path_factory, "host_msm", host_source("msm.cu", shared)
                + host_source("microbench.cu", kernels=False) + LAUNCHER)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.host_msm_reduce_rolled.argtypes = [P] * 9 + [LL, LL]
    lib.host_raw_u32.argtypes = [P, P, LL, ctypes.c_int, ctypes.c_int]
    return lib


def _host_reduce_rolled(lib, curve, seg_off, partials: Points) -> tuple[Points, int]:
    """msm_reduce_rolled's launches (its wrapper's plan) on the host lib; the
    result and the launch count."""
    n_seg = seg_off.shape[0] - 1
    plan = mk.rolled_passes(seg_off, int((seg_off[1:] - seg_off[:-1]).max()))
    off, pts = seg_off, list(partials)
    for piece_off in plan:
        n_rows = n_seg if piece_off is None else int(piece_off[-1])
        out = [torch.empty((n_rows, 8), dtype=torch.int64) for _ in range(3)]
        lib.host_msm_reduce_rolled(_build.field_consts(curve.fb), off.data_ptr(),
                                   None if piece_off is None else piece_off.data_ptr(), *(t.data_ptr() for t in pts),
                                   *(t.data_ptr() for t in out), n_seg, pts[0].shape[0])
        off, pts = piece_off, out
    return Points(*pts), len(plan)


def _partials(curve, n: int, seed: int) -> Points:
    """n Jacobian points (z != 1) drawn from 64 distinct multiples of the
    generator, so segments hold equal pairs (the doubling branch); every
    17th an identity and every 23rd the negation of the point before it."""
    rng = np.random.default_rng(seed)
    G = gold.generator(curve.spec)
    base = curve.dbl(curve.encode([G.mul(int(rng.integers(1, 1 << 40))) for _ in range(64)], "cpu"))
    idx = torch.from_numpy(rng.integers(0, 64, size=n))
    P = Points(*(c[idx].clone() for c in base))
    ident = curve.identity((1,), "cpu")
    for i in range(0, n, 17):
        for c, z in zip(P, ident):
            c[i] = z[0]
    for i in range(23, n, 23):
        neg = curve.neg(Points(*(c[i - 1 : i] for c in P)))
        for c, v in zip(P, neg):
            c[i] = v[0]
    return P


SPAN = mk.ROLLED_SPAN
LENGTHS = [0, 1, 2, 31, 32, 33, SPAN - 1, SPAN, SPAN + 1, 5000]


@pytest.mark.parametrize("curve", [BN256_G1, GRUMPKIN], ids=["bn256_g1", "grumpkin"])
def test_reduce_rolled_kernel_on_the_host_equals_twin(host_lib, curve):
    """S1 at segment lengths 0, 1, 2, 31, 32, 33, span - 1, span, span + 1
    and 5,000 (20 pieces: a second launch), in affine form its twin's."""
    lens = [3, *LENGTHS, 0, 7]
    seg_off = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int64)
    parts = _partials(curve, int(seg_off[-1]), 5)
    got, launches = _host_reduce_rolled(host_lib, curve, seg_off, parts)
    assert launches == 2
    assert curve.decode(got) == curve.decode(mk.msm_reduce_rolled_plain(curve, seg_off, parts))


def test_reduce_rolled_kernel_on_the_host_short_segments(host_lib):
    """S1 in one launch on many short segments (the timed shape's kind: up to
    32 partials), the spans cutting no segment short of its pieces, against
    msm_reduce's twin; a run starting at seg_off[0] > 0 too."""
    curve = BN256_G1
    rng = np.random.default_rng(9)
    lens = rng.integers(0, 33, size=90)
    seg_off = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int64)
    parts = _partials(curve, int(seg_off[-1]) + 11, 6)
    for off in (seg_off, seg_off + 11):
        got, launches = _host_reduce_rolled(host_lib, curve, off, parts)
        assert launches == 1
        assert curve.decode(got) == curve.decode(mk.msm_reduce_plain(curve, off, parts))


@pytest.mark.parametrize("op", ["mul", "add"])
def test_raw_u32_chains_on_the_host_equal_twin(host_lib, op):
    """S3's chains (straight-line at 64 reps, a loop of that body and a
    remainder otherwise, the ragged tail one value at a time) on 0, 1,
    0xFFFFFFFF and random words, word for word the twin's."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, size=4099, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 0xFFFFFFFF]
    for reps in (0, 1, 64, 65, 200):
        out = np.empty_like(a)
        host_lib.host_raw_u32(a.ctypes.data, out.ctypes.data, a.size, mb.RAW_OPS.index(op), reps)
        want = mb.raw_u32_plain(torch.from_numpy(a.view(np.int32)), op, reps)
        assert np.array_equal(out.view(np.int32), want.numpy()), reps
