"""Host rehearsal of the multiplicity count `m_count` (`csrc/lookup.cu`): the
kernels' row functions, built with g++ and run on the CPU through ctypes
(`host_kernels.py`), against the plain version `ops/lookup_kernels.py:m_count_plain`.
The insert runs its rows on several `std::thread`s at once in a shuffled
order, atomicCAS and atomicMin as the C++ atomic builtins, so a later row
often claims a slot before an earlier duplicate (the first-occurrence rule
rests on atomicMin); the probe runs after every insert, as the card's
second launch does.  Skipped where g++ is absent.
"""

import ctypes

import numpy as np
import pytest
import torch
from host_kernels import build, host_source

from sirius_tpu_torch.fields.jfield import FR
from sirius_tpu_torch.ops import lookup_kernels
from sirius_tpu_torch.ops.lookup_kernels import m_count_plain

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

ATOMICS = r"""
static inline int atomicCAS(int* p, int expected, int desired) {
  __atomic_compare_exchange_n(p, &expected, desired, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
  return expected;
}
static inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
"""

LAUNCHER = r"""
// The two launches of sirius_lookup_insert / sirius_lookup_probe: the insert
// over `workers` threads, rows in the given order; then the probe.
extern "C" void host_m_count(const long long* l, const long long* t, int* slots, int* counts, long long nl,
                             long long n, long long cap, const int* order, int workers) {
  const uint32_t mask = (uint32_t)(cap - 1);
  std::vector<std::thread> ts;
  for (int w = 0; w < workers; ++w)
    ts.emplace_back([=] {
      for (long long k = w; k < n; k += workers) lookup_insert_row(t, slots, mask, order[k]);
    });
  for (auto& th : ts) th.join();
  for (long long j = 0; j < nl; ++j) lookup_probe_row(l, t, slots, counts, mask, (int)j);
}
"""


ATOMIC_MIN = "atomicMin(&slots[s], i);"


def _load(tmp_path_factory, name, device_code):
    lib = build(tmp_path_factory, name, ATOMICS + device_code + LAUNCHER)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.host_m_count.argtypes = [P] * 4 + [LL, LL, LL, P, ctypes.c_int]
    lib.host_m_count.restype = None
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _load(tmp_path_factory, "host_lookup", host_source("lookup.cu", kernels=False))


def _host_m_count(lib, l, t, seed):
    n = t.shape[0]
    cap = lookup_kernels.table_capacity(n)
    slots = torch.full((cap,), lookup_kernels.EMPTY, dtype=torch.int32)
    counts = torch.zeros(n, dtype=torch.int32)
    order = torch.from_numpy(np.random.default_rng(seed).permutation(n).astype(np.int32))
    lib.host_m_count(l.data_ptr(), t.data_ptr(), slots.data_ptr(), counts.data_ptr(), l.shape[0], n, cap,
                     order.data_ptr(), 4)
    return counts


def _case(name, rng):
    """(l, t) as Montgomery words: values from a small range give duplicate
    groups in t and misses and repeats in l."""
    if name == "n1":
        return FR.encode([5], "cpu"), FR.encode([5], "cpu")
    n = {"dups_64": 64, "ragged_1000": 1000, "table_4096": 4096}[name]
    span = max(4, n // 8)
    t = [int(v) for v in rng.integers(0, span, size=n)]
    l = [int(v) for v in rng.integers(0, span + span // 4, size=n)]
    if name == "table_4096":  # a byte table repeated 16 times, as the range circuit's
        t = [row % 256 for row in range(n)]
    return FR.encode(l, "cpu"), FR.encode(t, "cpu")


@pytest.mark.parametrize("name", ["dups_64", "ragged_1000", "table_4096", "n1"])
def test_m_count_kernel_rows_match_the_plain_version(host_lib, name):
    rng = np.random.default_rng(23)
    l, t = _case(name, rng)
    want = m_count_plain(l, t)
    assert int(want.sum()) > 0
    for seed in range(3):
        assert torch.equal(_host_m_count(host_lib, l, t, seed), want)


def test_m_count_kernel_rows_without_the_atomic_min_fail(tmp_path_factory):
    """The mutation check of the rehearsal: a copy of the insert with its
    atomicMin removed keeps whichever duplicate claimed the slot first, so
    on the byte table repeated 16 times, rows inserted in shuffled orders,
    it must disagree with the plain version in every order."""
    device_code = host_source("lookup.cu", kernels=False)
    assert device_code.count(ATOMIC_MIN) == 1
    lib = _load(tmp_path_factory, "host_lookup_no_min", device_code.replace(ATOMIC_MIN, ""))
    l, t = _case("table_4096", np.random.default_rng(23))
    want = m_count_plain(l, t)
    for seed in range(3):
        assert not torch.equal(_host_m_count(lib, l, t, seed), want)
