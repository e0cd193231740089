"""Host rehearsal of the wide product `fe_mul_wide` (`csrc/field.cuh`), of the
ring ops' add/sub kernel `addsub_rows` (`csrc/field_ops.cu`) and of B1's
batched madd kernel (`csrc/madd.cu`): the kernels' own code, built with
g++ and run on the CPU through ctypes (`host_kernels.py`).  Off the device
each PTX op of the wide product is emulated with an explicit carry flag in
the same order, so its carries, folds and role swaps run here; only the asm
text itself is left to the card's checks (`tests/test_torch_gpu.py`).
Skipped where g++ is absent.
"""

import ctypes

import numpy as np
import pytest
import torch
from host_kernels import build, host_source

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.jfield import FQ, FR, ints_to_words, words_to_ints
from sirius_tpu_torch.ops import _build
from sirius_tpu_torch.ops import field_kernels as fk
from sirius_tpu_torch.ops.madd import madd_plain

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

LAUNCHER = r"""
// mul_rows_kernel on the wide product, as sirius_mul_rows launches it (rep 1, nb = n).
extern "C" void host_mul_rows_wide(const uint32_t* consts, const long long* a, const long long* b, long long* out,
                                   long long n, int K) {
  const FieldConst fc = make_field_const(consts);
  const unsigned threads = 128, ept = mul_rows_ept(K), blocks = (unsigned)((n + threads * ept - 1) / (threads * ept));
  run_grid(blocks, threads, [=] {
    if (ept == 2)
      mul_rows_kernel<2, false, false, 4>(fc, a, b, out, (unsigned)n, (unsigned)n, 1u, 1u, 1u, K);
    else
      mul_rows_kernel<1, false, false, 4>(fc, a, b, out, (unsigned)n, (unsigned)n, 1u, 1u, 1u, K);
  });
}

// fe_mul_wide_n<3> on rows i, i + 1, i + 2 (n a multiple of 3): the interleaved form.
extern "C" void host_mul_wide3(const uint32_t* consts, const long long* a, const long long* b, long long* out,
                               long long n) {
  const FieldConst fc = make_field_const(consts);
  for (long long i = 0; i < n; i += 3) {
    Fe x[3], y[3], r[3];
    for (int k = 0; k < 3; ++k) {
      x[k] = fe_load(a, i + k);
      y[k] = fe_load(b, i + k);
    }
    fe_mul_wide_n<3>(r, x, y, fc);
    for (int k = 0; k < 3; ++k) fe_store(out, i + k, r[k]);
  }
}

// addsub_rows_kernel as sirius_addsub_rows launches it (its instance by wrap and op).
template <int OP>
static void host_addsub_op(const FieldConst& fc, const long long* a, const long long* b, long long* out, unsigned n,
                           unsigned nb, unsigned sa, unsigned sb) {
  const unsigned threads = 128, blocks = (n + threads * 2 - 1) / (threads * 2);
  run_grid(blocks, threads, [=] {
    if (nb != n)
      addsub_rows_kernel<true, OP>(fc, a, b, out, n, nb, sa, sb);
    else
      addsub_rows_kernel<false, OP>(fc, a, b, out, n, nb, sa, sb);
  });
}

extern "C" void host_addsub_rows(const uint32_t* consts, const long long* a, const long long* b, long long* out,
                                 long long n, long long nb, long long sa, long long sb, int op) {
  const FieldConst fc = make_field_const(consts);
  if (op == 0) host_addsub_op<0>(fc, a, b, out, n, nb, sa, sb);
  if (op == 1) host_addsub_op<1>(fc, a, b, out, n, nb, sa, sb);
  if (op == 2) host_addsub_op<2>(fc, a, b, out, n, nb, sa, sb);
}

// madd_kernel as sirius_madd launches it: a lane a thread, blocks of MADD_THREADS.
extern "C" void host_madd(const uint32_t* consts, const long long* x, const long long* y, const long long* z,
                          const long long* qx, const long long* qy, long long* ox, long long* oy, long long* oz,
                          long long n) {
  const FieldConst fc = make_field_const(consts);
  const unsigned blocks = (unsigned)((n + MADD_THREADS - 1) / MADD_THREADS);
  run_grid(blocks, MADD_THREADS, [=] { madd_kernel(fc, x, y, z, qx, qy, ox, oy, oz, n); });
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory, "host_field", host_source("field_ops.cu") + host_source("madd.cu") + LAUNCHER)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.host_mul_rows_wide.argtypes = [P] * 4 + [LL, ctypes.c_int]
    lib.host_mul_wide3.argtypes = [P] * 4 + [LL]
    lib.host_madd.argtypes = [P] * 9 + [LL]
    lib.host_addsub_rows.argtypes = [P] * 4 + [LL] * 4 + [ctypes.c_int]
    return lib


def _operands(field, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n random canonical pairs, then every pair of 0, 1, p - 1 and R mod p."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, field.p - 1, (1 << 256) % field.p]
    ea = torch.from_numpy(ints_to_words([e for e in edge for _ in edge]))
    eb = torch.from_numpy(ints_to_words(edge * len(edge)))
    return (torch.cat([field.random((n,), rng, "cpu"), ea]), torch.cat([field.random((n,), rng, "cpu"), eb]))


def _gold_chain(field, a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """a_i (b_i R^-1)^K mod p on Python ints: K Montgomery products."""
    p, rinv = field.p, pow(1 << 256, -1, field.p)
    out = []
    for x, y in zip(words_to_ints(a.numpy()), words_to_ints(b.numpy())):
        for _ in range(K):
            x = x * y * rinv % p
        out.append(x)
    return torch.from_numpy(ints_to_words(out))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_wide_product_on_the_host_equals_twin_and_gold(host_lib, field, K):
    """mul_rows on the wide product (K = 1: two elements a thread; K = 3:
    one), random words and every edge pair, word for word mul_rows_plain
    and the Python-int product."""
    a, b = _operands(field, 300, K)
    out = torch.empty_like(a)
    host_lib.host_mul_rows_wide(_build.field_consts(field), a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], K)
    assert torch.equal(out, fk.mul_rows_plain(field, a, b, K))
    assert torch.equal(out, _gold_chain(field, a, b, K))


@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_wide_product_interleaved_on_the_host(host_lib, field):
    """fe_mul_wide_n<3> (B1's widest level) equals the single product's words."""
    a, b = _operands(field, 299, 5)  # 299 + 16 rows: a multiple of 3
    out = torch.empty_like(a)
    host_lib.host_mul_wide3(_build.field_consts(field), a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0])
    assert torch.equal(out, _gold_chain(field, a, b, 1))


def _addsub_operands(field, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n random canonical pairs (a ragged count), then the edges: every pair
    of 0, 1 and p - 1, a + b = p, a = b, and b > a."""
    rng = np.random.default_rng(seed)
    p, x = field.p, int(rng.integers(1, 2**62)) << 190
    edge = [0, 1, p - 1]
    pairs = [(u, v) for u in edge for v in edge] + [(x, p - x), (p - x, x), (x, x), (5, p - 3), (x - 1, x)]
    ea = torch.from_numpy(ints_to_words([u for u, _ in pairs]))
    eb = torch.from_numpy(ints_to_words([v for _, v in pairs]))
    return torch.cat([field.random((n,), rng, "cpu"), ea]), torch.cat([field.random((n,), rng, "cpu"), eb])


@pytest.mark.parametrize("op", fk.ADDSUB_OPS)
@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_addsub_kernel_on_the_host_equals_the_limb_arithmetic(host_lib, field, op):
    """addsub_rows_kernel on every instance its wrapper launches: b of n
    rows, one row (a scalar) and 7 rows wrapped, over a ragged n (no
    multiple of 256: the second block part idle), a read at row stride 2 and
    b at 1 or 3; random words and every edge, word for word the limb
    arithmetic of `Field` and the Python-int sum."""
    a, b = _addsub_operands(field, 294, len(op))  # 294 + 14 = 308 rows
    n, p = a.shape[0], field.p
    wide = torch.zeros(2 * n, 8, dtype=torch.int64)
    wide[0::2] = a
    for nb, sb in ((n, 1), (1, 1), (7, 1), (7, 3)):
        bb = b[: nb]
        b_wide = torch.zeros(3 * nb, 8, dtype=torch.int64)
        b_wide[0::sb][:nb] = bb
        out = torch.empty_like(a)
        host_lib.host_addsub_rows(_build.field_consts(field), wide.data_ptr(), b_wide.data_ptr(), out.data_ptr(), n,
                                  nb, 2, sb, fk.ADDSUB_OPS.index(op))
        y = fk._broadcast_rows(bb, n, 1)
        f = field.limbs
        want = f.add(a, y) if op == "add" else f.sub(a, y) if op == "sub" else f.sub(y, a)
        assert torch.equal(out, want), (nb, sb)
        sign = {"add": (1, 1), "sub": (1, -1), "rsub": (-1, 1)}[op]
        gold = [(sign[0] * u + sign[1] * v) % p for u, v in zip(words_to_ints(a.numpy()), words_to_ints(y.numpy()))]
        assert words_to_ints(out.numpy()) == gold, (nb, sb)


def _madd_case(curve, n: int) -> tuple[Points, torch.Tensor, torch.Tensor]:
    """Jacobian P = 2 (i + 1) G (z != 1) with identity rows at 0, 5 and the
    last, affine Q = (i + 5000) G (never +-P)."""
    g = gold.generator(curve.spec)
    pts, cur = [], g
    for _ in range(n + 5000):
        pts.append(cur)
        cur = cur.add(g)
    P = curve.dbl(curve.encode(pts[:n], "cpu"))
    P = Points(*(c.clone() for c in P))
    one = curve.identity((1,), "cpu")
    for i in (0, 5, n - 1):
        for c, e in zip(P, one):
            c[i] = e[0]
    Q = curve.encode(pts[5000 : 5000 + n], "cpu")
    return P, Q.x.contiguous(), Q.y.contiguous()


@pytest.mark.parametrize("n", [128, 200], ids=["one_block", "two_blocks_ragged"])
@pytest.mark.parametrize("curve", [BN256_G1, GRUMPKIN], ids=["bn256_g1", "grumpkin"])
def test_madd_kernel_on_the_host_equals_twin(host_lib, curve, n):
    """madd_kernel whole (pt_madd_wide in its dependency levels, a lane a
    thread): one full block, and two over a ragged 200 lanes (idle threads
    in the second), identity rows included, word for word madd_plain."""
    P, qx, qy = _madd_case(curve, n)
    out = [torch.empty_like(qx) for _ in range(3)]
    host_lib.host_madd(_build.field_consts(curve.fb), *(t.data_ptr() for t in (*P, qx, qy)),
                       *(t.data_ptr() for t in out), n)
    want = madd_plain(curve, P, qx, qy)
    assert all(torch.equal(g, w) for g, w in zip(out, want))
