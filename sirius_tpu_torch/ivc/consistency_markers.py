"""Consistency-marker hashes for Sangria IVC.

The port's own copy of `sirius_tpu/ivc/consistency_markers.py` (reference
`src/ivc/sangria/consistency_markers_computation.rs`): X = RO(pp_hash,
step, z_0, z_i, U-with-bignum-limbs) truncated to 128 bits and cast to the
paired curve's scalar field.

Limb geometry of the marker hash: 32-bit x 10 limbs, as `sirius_tpu` has
it (PARITY.md deviation 7; the reference crate's `src/lib.rs:81-87` differs).
"""

from __future__ import annotations

from typing import Sequence

from ..fields.constants import CurveSpec
from ..nifs.sangria import RelaxedPlonkInstance
from ..ops.poseidon import PoseidonHash, PoseidonSpec
from ..util.ro import NUM_CHALLENGE_BITS

DEFAULT_MARKER_LIMB_WIDTH = 32
DEFAULT_MARKER_LIMBS_COUNT = 10


def scalar_to_limbs(v: int, width: int = DEFAULT_MARKER_LIMB_WIDTH, count: int = DEFAULT_MARKER_LIMBS_COUNT) -> list[int]:
    mask = (1 << width) - 1
    return [(v >> (i * width)) & mask for i in range(count)]


def generate_consistency_marker(spec: PoseidonSpec, curve: CurveSpec, public_params_hash, step: int,
                                z_0: Sequence[int], z_i: Sequence[int], relaxed: RelaxedPlonkInstance) -> int:
    """Absorb order (reference `:160-178`): the pp point (a `gold` point on
    `curve`), step, z_0, z_i, then the relaxed instance as [W commits | E
    commit | marker limbs | challenge limbs | u | sc-hash-acc]; every scalar
    is cast to `curve`'s base field before its limbs are taken."""
    base_p = curve.base.modulus
    ro = PoseidonHash(spec)
    ro.absorb_point(public_params_hash)
    ro.absorb_field(step % base_p)
    for v in [*z_0, *z_i]:
        ro.absorb_field(v % base_p)
    for c in relaxed.W_commitments:
        ro.absorb_point(c)
    ro.absorb_point(relaxed.E_commitment)
    for m in [*relaxed.consistency_markers, *relaxed.challenges]:
        for limb in scalar_to_limbs(m % base_p):
            ro.absorb_field(limb)
    ro.absorb_field(relaxed.u % base_p)
    ro.absorb_field(0 if relaxed.sc_instances_hash_acc is None else relaxed.sc_instances_hash_acc % base_p)
    return ro.squeeze(NUM_CHALLENGE_BITS) % curve.scalar.modulus
