"""Port Poseidon transcript: the reference golden vector and agreement with
the JAX package's `PoseidonHash` and optimized schedule."""

import numpy as np
import pytest
import torch

from sirius_tpu.fields.constants import bn256_fq, bn256_fr, pasta_fp
from sirius_tpu.ops import poseidon as jpos
from sirius_tpu_torch.ops import poseidon as tpos
from sirius_tpu_torch.util.ro import default_ro, default_ro_spec

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def test_golden_vector():
    h = tpos.PoseidonHash(tpos.poseidon_spec(pasta_fp, 3, 2, 4, 3))
    assert h.absorb_iter(range(5)).squeeze(128) == 277726250230731218669330566268314254439


@pytest.mark.parametrize("field", [bn256_fq, bn256_fr], ids=lambda f: f.name)
@pytest.mark.parametrize("n_abs", [0, 3, 4, 9])
def test_matches_jax_poseidon(field, n_abs):
    rng = np.random.default_rng(n_abs)
    vals = [int(v) for v in rng.integers(0, 2**63, n_abs)] + [field.modulus - 1] * (n_abs > 0)
    spec_t = default_ro_spec(field)
    spec_j = jpos.poseidon_spec(field, 5, 4, 10, 10)
    assert spec_t.round_constants == spec_j.round_constants and spec_t.mds == spec_j.mds
    assert vars(tpos.optimized_spec(spec_t)) == vars(jpos.optimized_spec(spec_j))
    ht, hj = default_ro(field), jpos.PoseidonHash(spec_j)
    for v in vals:
        ht.absorb_field(v)
        hj.absorb_field(v)
    assert ht.squeeze(128) == hj.squeeze(128)
    assert ht.squeeze(field.num_bits) == hj.squeeze(field.num_bits)
    state = spec_t.initial_state
    assert tpos.permute_optimized(spec_t, state, vals[:4]) == jpos.permute(spec_j, state, vals[:4])
