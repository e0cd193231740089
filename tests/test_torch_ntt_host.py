"""Host rehearsal of B4 (`csrc/ntt.cu`) and the field product `mul_rows`
(`csrc/field_ops.cu`): the kernels' own code, built with g++ and run on the
CPU through ctypes (`host_kernels.py`: one `std::thread` per CUDA thread,
barriers and all), against the plain torch twins.  So the kernels' order
of operations, their shared-memory slots and their index arithmetic are
checked here, and only the PTX asm is left to the card's checks
(`tests/test_torch_gpu.py`).  Skipped where g++ is absent.
"""

import ctypes

import numpy as np
import pytest
import torch
from host_kernels import build, host_source

from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.fields.jfield import FR
from sirius_tpu_torch.ops import _build
from sirius_tpu_torch.ops import field_kernels as fk
from sirius_tpu_torch.ops import ntt_kernels
from sirius_tpu_torch.ops.ntt import NTT, _bit_reverse_indices

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

LAUNCHER = r"""
extern "C" void host_col_ntt(const uint32_t* consts, const long long* a, const long long* rev,
                             const long long* table, const long long* mid, long long* out, long long size,
                             long long R, long long rep) {
  int L = 0;
  while ((1LL << L) < size) ++L;
  const long long C = col_ntt_columns(L, R);
  const FieldConst fc = make_field_const(consts);
  const bool w3 = col_ntt_window(L) == 3;
  run_grid((unsigned)((R + C - 1) / C), (unsigned)(C * col_ntt_threads(L)), [=] {
    if (mid && w3)
      col_ntt_kernel<3, true>(fc, a, rev, table, mid, out, L, R, rep);
    else if (mid)
      col_ntt_kernel<2, true>(fc, a, rev, table, mid, out, L, R, rep);
    else if (w3)
      col_ntt_kernel<3, false>(fc, a, rev, table, nullptr, out, L, R, rep);
    else
      col_ntt_kernel<2, false>(fc, a, rev, table, nullptr, out, L, R, rep);
  });
}

template <int EPT, int P>
static void host_mul_rows_e(const FieldConst& fc, const long long* a, const long long* b, long long* out,
                            unsigned n, unsigned nb, unsigned rep, int K) {
  const unsigned threads = 128, blocks = (n + threads * EPT - 1) / (threads * EPT);
  const bool wrap = (unsigned long long)nb * rep != n;
  run_grid(blocks, threads, [=] {
    if (rep > 1 && wrap)
      mul_rows_kernel<EPT, true, true, P>(fc, a, b, out, n, nb, rep, 1u, 1u, K);
    else if (rep > 1)
      mul_rows_kernel<EPT, true, false, P>(fc, a, b, out, n, nb, rep, 1u, 1u, K);
    else if (wrap)
      mul_rows_kernel<EPT, false, true, P>(fc, a, b, out, n, nb, rep, 1u, 1u, K);
    else
      mul_rows_kernel<EPT, false, false, P>(fc, a, b, out, n, nb, rep, 1u, 1u, K);
  });
}

template <int P>
static void host_mul_rows_p(const FieldConst& fc, const long long* a, const long long* b, long long* out,
                            unsigned n, unsigned nb, unsigned rep, int K) {
  if (mul_rows_ept(K) == 2)
    host_mul_rows_e<2, P>(fc, a, b, out, n, nb, rep, K);
  else
    host_mul_rows_e<1, P>(fc, a, b, out, n, nb, rep, K);
}

extern "C" void host_mul_rows(const uint32_t* consts, const long long* a, const long long* b, long long* out,
                              long long n, long long nb, long long rep, int K, int product) {
  const FieldConst fc = make_field_const(consts);
  if (product == 0) host_mul_rows_p<0>(fc, a, b, out, n, nb, rep, K);
  if (product == 1) host_mul_rows_p<1>(fc, a, b, out, n, nb, rep, K);
  if (product == 2) host_mul_rows_p<2>(fc, a, b, out, n, nb, rep, K);
  if (product == 3) host_mul_rows_p<3>(fc, a, b, out, n, nb, rep, K);
  if (product == 4) host_mul_rows_p<4>(fc, a, b, out, n, nb, rep, K);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    shared = {"extern __shared__ uint32_t col_ntt_smem[];": "static uint32_t col_ntt_smem[1 << 16];"}
    lib = build(tmp_path_factory, "host_kernels", host_source("field_ops.cu") + host_source("ntt.cu", shared)
                + LAUNCHER)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.host_col_ntt.argtypes = [P] * 6 + [LL] * 3
    lib.host_mul_rows.argtypes = [P] * 4 + [LL] * 3 + [ctypes.c_int] * 2
    return lib


def _ptr(t: torch.Tensor):
    return None if t is None else t.data_ptr()


def _host_col_ntt(lib, a, rev, table, mid=None, rep=1):
    size, R = a.shape[:2]
    out = a.new_empty(a.shape) if mid is None else a.new_empty((R // rep, size * rep, 8))
    lib.host_col_ntt(_build.field_consts(FR), _ptr(a), _ptr(rev), _ptr(table), _ptr(mid), _ptr(out), size, R, rep)
    return out


def _table(k: int, inverse: bool) -> torch.Tensor:
    """(max(2^k / 2, 1), 8): w^j for the order-2^k root w (or its inverse)."""
    p = FR.p
    w = gold.omega_for_k(bn256_fr, k)
    w = pow(w, -1, p) if inverse else w
    return FR.encode([pow(w, j, p) for j in range(max((1 << k) // 2, 1))], "cpu")


def _mid(k: int, inverse: bool) -> torch.Tensor:
    """T[o1 * n2 + i2] = w^(+-o1 i2) (times 1/n when inverse) for n = 2^k."""
    p, n1, n2 = FR.p, 1 << ((k + 1) // 2), 1 << (k // 2)
    w = gold.omega_for_k(bn256_fr, k)
    w = pow(w, -1, p) if inverse else w
    s = pow(1 << k, -1, p) if inverse else 1
    return FR.encode([s * pow(w, o1 * i2, p) % p for o1 in range(n1) for i2 in range(n2)], "cpu")


@pytest.mark.parametrize("size,R", [(1, 3), (2, 5), (4, 3), (8, 3), (16, 300), (32, 70), (64, 33), (256, 9),
                                    (512, 5), (1024, 3), (2048, 2), (4096, 1)])
def test_col_ntt_kernel_on_the_host_equals_twin(host_lib, size, R):
    """B4 at every pass count (windows of 2 bits up to 1024, 3 above; a
    first pass of 1, 2 or 3 stages), partial blocks, both directions, word
    for word."""
    rng = np.random.default_rng(size + R)
    a = FR.random((size, R), rng, "cpu")
    k = size.bit_length() - 1
    rev = torch.from_numpy(_bit_reverse_indices(k))
    for table in (_table(k, False), _table(k, True)):
        assert torch.equal(_host_col_ntt(host_lib, a, rev, table), ntt_kernels.col_ntt_plain(FR, a, rev, table))


@pytest.mark.parametrize("k,R", [(6, 1), (9, 1), (10, 1), (11, 1), (10, 3)], ids=["k6", "k9", "k10", "k11", "k10_R3"])
def test_col_ntt_epilogue_on_the_host_equals_twin(host_lib, k, R):
    """The epilogue pass (times the mid twiddle, transposed) at the four-step
    shapes of k = 6 .. 11 (n1 = n2 and n1 = 2 n2), R = 1 and a nested
    context's R = 3 (the mid twiddle broadcast over rep = R), both
    directions, word for word its twin, and pass 2 after it equals the
    context's transform."""
    ctx = NTT(FR, k, "cpu")
    n1, n2 = 1 << ((k + 1) // 2), 1 << (k // 2)
    rng = np.random.default_rng(k)
    a = FR.random((1 << k, R), rng, "cpu")
    for inverse in (False, True):
        T = _mid(k, inverse)
        A = a.reshape(n1, n2 * R, 8)
        rev1 = torch.from_numpy(_bit_reverse_indices((k + 1) // 2))
        got = _host_col_ntt(host_lib, A, rev1, _table((k + 1) // 2, inverse), T, rep=R)
        want = ntt_kernels.col_ntt_plain(FR, A, rev1, _table((k + 1) // 2, inverse), T, rep=R)
        assert torch.equal(got, want)
        rev2 = torch.from_numpy(_bit_reverse_indices(k // 2))
        E = _host_col_ntt(host_lib, got, rev2, _table(k // 2, inverse)).reshape(1 << k, R, 8)
        for r in range(R):
            assert torch.equal(E[:, r], ctx.fft(a[:, r].contiguous(), inverse))


@pytest.mark.parametrize("n,nb,rep", [(1000, 1000, 1), (1000, 3, 1), (1000, 250, 4), (1000, 7, 4), (1, 1, 1)],
                         ids=["nb_n", "nb3", "rep4", "rep4_wrap", "one"])
def test_mul_rows_kernel_on_the_host_equals_twin(host_lib, n, nb, rep):
    """mul_rows at K = 1 (two elements a thread) and 3 (one) on every
    product, every instance (rep = 1 or > 1, with or without the modulo),
    word for word its twin."""
    rng = np.random.default_rng(n + nb + rep)
    a, b = FR.random((n,), rng, "cpu"), FR.random((nb,), rng, "cpu")
    for K in (1, 3):
        want = fk.mul_rows_plain(FR, a, b, K, rep)
        for i, product in enumerate(fk.PRODUCTS):
            out = torch.empty_like(a)
            host_lib.host_mul_rows(_build.field_consts(FR), a.data_ptr(), b.data_ptr(), out.data_ptr(), n, nb, rep,
                                   K, i)
            assert torch.equal(out, want), (K, product)
