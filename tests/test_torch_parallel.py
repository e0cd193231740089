"""The port's multi-device layer (`sirius_tpu_torch/parallel/`,
`ops/msm.msm_sharded`, `NTT.fft_sharded`) against the JAX package's on the
CPU: the port's meshes are explicit lists of CPU devices (`make_mesh(
devices=['cpu'] * 8)`), the JAX package's the 8 virtual CPU devices of
`tests/conftest.py`; the same inputs from a numpy seed go through both.
Exact: canonical words, points compared in affine form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.curves.jpoint import Points as JPoints
from sirius_tpu.fields.jfield import FR as J_FR
from sirius_tpu.ops.msm import msm_sharded as jax_msm_sharded
from sirius_tpu.ops.ntt import ntt_ctx as jax_ntt_ctx
from sirius_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.fields.jfield import FR, ints_to_words
from sirius_tpu_torch.ops import ntt_kernels
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops import msm as msm_mod
from sirius_tpu_torch.ops.msm import bucket_plan, msm_sharded, signed_window_bits
from sirius_tpu_torch.ops.ntt import NTT
from sirius_tpu_torch.parallel import Mesh, gather_rows, get_mesh, make_mesh, mesh_context, row_blocks, set_mesh
from sirius_tpu_torch.parallel import shard_rows
from sirius_tpu_torch.util.interop import affine_from, words_to_limbs

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=CPU8)


def test_mesh_context_nests_and_restores_through_an_exception():
    outer, inner = make_mesh(devices=["cpu"] * 2), make_mesh(devices=["cpu"] * 4)
    assert get_mesh() is None
    with mesh_context(outer) as m:
        assert m is outer and get_mesh() is outer
        with pytest.raises(ZeroDivisionError):
            with mesh_context(inner):
                assert get_mesh() is inner
                1 / 0
        assert get_mesh() is outer
        with mesh_context(inner):
            assert get_mesh() is inner
        assert get_mesh() is outer
    assert get_mesh() is None
    set_mesh(inner)
    try:
        assert get_mesh() is inner
    finally:
        set_mesh(None)


def test_make_mesh_names_its_devices_and_refuses_missing_cards():
    mesh = make_mesh(devices=CPU8)
    assert mesh.size == 8 and mesh.first == torch.device("cpu") and mesh.distinct == (torch.device("cpu"),)
    assert mesh == Mesh((torch.device("cpu"),) * 8) and hash(mesh) == hash(Mesh((torch.device("cpu"),) * 8))
    assert mesh.describe() == "8 shards on 1 device (cpu)"
    assert make_mesh(devices=["cpu"]).describe() == "1 shard on 1 device (cpu)"
    with pytest.raises(ValueError):
        make_mesh(3, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            make_mesh(torch.cuda.device_count() + 1)
        return
    # without a card, a mesh of CUDA devices raises instead of carrying on on the CPU
    for call in (lambda: make_mesh(), lambda: make_mesh(1), lambda: make_mesh(devices=["cuda:0"] * 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("n", [0, 3, 8, 13, 96, 1000])
def test_shard_rows_and_gather_rows_round_trip(mesh8, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64))
    blocks = shard_rows(mesh8, x)
    bounds = row_blocks(n, 8)
    assert [tuple(b.shape) for b in blocks] == [(hi - lo, 8) for lo, hi in bounds]
    assert [hi - lo for lo, hi in bounds] == [len(a) for a in np.array_split(np.arange(n), 8)]
    for b, (lo, hi) in zip(blocks, bounds):
        assert torch.equal(b, x[lo:hi])
        if hi > lo:  # on x's own device a block is a view, not a copy
            assert b.data_ptr() == x[lo:].data_ptr()
    assert torch.equal(gather_rows(mesh8, blocks), x)
    cols = shard_rows(mesh8, x.T.contiguous(), axis=1)
    assert torch.equal(gather_rows(mesh8, cols, axis=1), x.T)


def _scalars(curve, rng, n):
    """tests/test_curve.py::test_msm_sharded_vs_gold's draw: full-width
    scalars, scalars[0] = 0."""
    scalars = [int(a) | (int(b) << 63) | (int(c) << 126) | (int(d) << 189)
               for a, b, c, d in rng.integers(0, 2**63, size=(n, 4))]
    scalars = [s % curve.fs.p for s in scalars]
    scalars[0] = 0
    return scalars


@pytest.mark.parametrize("curve,jcurve,n", [(BN256_G1, J_BN256, 96), (GRUMPKIN, J_GRUMPKIN, 96), (BN256_G1, J_BN256, 5)],
                         ids=["bn256_96", "grumpkin_96", "bn256_5"])
def test_msm_sharded_matches_the_jax_package_and_gold(mesh8, curve, jcurve, n, monkeypatch):
    """96 points over 8 shards (12 each) and 5 over 8 (three empty shards,
    which get no plan and add the identity); every plan takes the longest
    shard's window width.  The JAX package pads to a multiple of 8 x 8 with
    identity points, the port cuts uneven blocks.  The JAX package takes the
    n = 5 terms zero-extended to 96 (zero scalars add nothing), which reuses
    its compiled n = 96 program."""
    plans = []

    def recording(S, c=None):
        plans.append((S.shape[0], c))
        return bucket_plan(S, c)

    monkeypatch.setattr(msm_mod, "bucket_plan", recording)
    ck = CommitmentKey.setup(curve, 7, b"torch-parallel", use_cache=False, device="cpu")
    scalars = _scalars(curve, np.random.default_rng(0x5EED + n), n)
    S = torch.from_numpy(ints_to_words(scalars))
    got = msm_sharded(curve, S, ck.points, mesh8)
    assert plans == [(hi - lo, signed_window_bits(-(-n // 8))) for lo, hi in row_blocks(n, 8) if hi > lo]
    want = gold.msm(scalars, ck.host_points()[:n])
    assert got == want
    S96 = torch.cat([S, S.new_zeros((96 - n, 8))])
    jpts = JPoints(*(jnp.asarray(words_to_limbs(c[:96])) for c in ck.points))
    jgot = jax_msm_sharded(jcurve, jnp.asarray(words_to_limbs(S96)), jpts, jax_make_mesh(8), window_bits=4,
                           group_count=8)
    assert affine_from(jgot) == got


def test_msm_sharded_of_no_scalars_is_the_identity(mesh8):
    ck = CommitmentKey.setup(BN256_G1, 4, b"torch-parallel-small", use_cache=False, device="cpu")
    assert msm_sharded(BN256_G1, torch.zeros((0, 8), dtype=torch.int64), ck.points, mesh8) == gold.identity(
        BN256_G1.spec)


def _sharded(mesh, k, xs, inverse):
    ctx = NTT(FR, k, "cpu")
    blocks = ctx.fft_sharded(shard_rows(mesh, FR.encode(xs, "cpu")), mesh, inverse)
    assert [tuple(b.shape) for b in blocks] == [(hi - lo, 8) for lo, hi in row_blocks(1 << k, mesh.size)]
    return ctx, blocks


def test_fft_sharded_k7_matches_the_jax_package_under_a_rows_sharding(mesh8):
    """tests/test_ntt.py::test_sharded_fft_multichip's program, both
    directions in one jit: the JAX package's transform with P('rows', None)
    in and out on its 8 devices.  k = 7 is below the four-step: the port
    gathers the blocks on the first device, transforms and cuts again."""
    k = 7
    xs = [int(x) for x in np.random.default_rng(5).integers(0, 2**62, size=1 << k)]
    jctx = jax_ntt_ctx(bn256_fr, k)
    sh = NamedSharding(jax_make_mesh(8), PartitionSpec("rows", None))
    both = jax.jit(lambda a: (jctx._fft(a, False), jctx._fft(a, True)), in_shardings=(sh,), out_shardings=(sh, sh))
    jax_out = both(jax.device_put(J_FR.encode(xs), sh))
    for inverse in (False, True):
        ctx, blocks = _sharded(mesh8, k, xs, inverse)
        got = FR.decode(gather_rows(mesh8, blocks))
        assert got == J_FR.decode(jax_out[inverse]) == gold.fft(xs, bn256_fr, inverse)
        assert torch.equal(gather_rows(mesh8, blocks), ctx.fft(FR.encode(xs, "cpu"), inverse))


@pytest.mark.parametrize("k,D,max_size", [(10, 8, None), (11, 8, None), (11, 4, None), (10, 8, 16)],
                         ids=["k10_D8", "k11_D8", "k11_D4", "k10_D8_nested"])
def test_fft_sharded_four_step_matches_gold_and_fft(k, D, max_size, monkeypatch):
    """The four-step across the mesh: B4's passes on every shard's columns,
    the mid twiddle by mul_rows, the transposes as copies; word for word
    `fft`, and `gold.fft`, both directions.  With MAX_SIZE 16 every pass is
    itself a nested four-step."""
    if max_size:
        monkeypatch.setattr(ntt_kernels, "MAX_SIZE", max_size)
    mesh = make_mesh(devices=["cpu"] * D)
    xs = [int(x) for x in np.random.default_rng(k).integers(0, 2**62, size=1 << k)]
    for inverse in (False, True):
        ctx, blocks = _sharded(mesh, k, xs, inverse)
        assert ctx.use_four_step
        assert torch.equal(gather_rows(mesh, blocks), ctx.fft(FR.encode(xs, "cpu"), inverse))
        assert FR.decode(gather_rows(mesh, blocks)) == gold.fft(xs, bn256_fr, inverse)


def test_fft_sharded_checks_its_blocks_and_the_mesh_size():
    mesh3 = make_mesh(devices=["cpu"] * 3)
    xs = list(range(1 << 5))
    ctx, blocks = _sharded(mesh3, 5, xs, False)  # uneven blocks below the four-step: gathered
    assert FR.decode(gather_rows(mesh3, blocks)) == gold.fft(xs, bn256_fr)
    ctx10 = NTT(FR, 10, "cpu")
    a = FR.encode(list(range(1 << 10)), "cpu")
    with pytest.raises(ValueError, match="dividing"):
        ctx10.fft_sharded(shard_rows(mesh3, a), mesh3)
    mesh8 = make_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="blocks"):
        ctx10.fft_sharded(shard_rows(mesh3, a), mesh8)
    with pytest.raises(ValueError, match="expected"):
        ctx10.fft_sharded(list(reversed(shard_rows(mesh8, a[:-8]))), mesh8)
