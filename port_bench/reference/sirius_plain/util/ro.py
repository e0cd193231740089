"""Random-oracle construction helpers.

Counterpart of `sirius_tpu/util/ro.py`, plus `default_ro_spec` (in the JAX
package at `sirius_tpu/ivc/sangria_ivc.py`): the main RO is Poseidon with
T=5, RATE=4, R_F=R_P=10; challenges are 128-bit squeezes.
"""

from __future__ import annotations

from ..fields.constants import FieldSpec
from ..ops.poseidon import PoseidonSpec, poseidon_spec

NUM_HASH_BITS = 250
NUM_CHALLENGE_BITS = 128

DEFAULT_T = 5
DEFAULT_RATE = 4
DEFAULT_R_F = 10
DEFAULT_R_P = 10


def default_ro_spec(field: FieldSpec) -> PoseidonSpec:
    return poseidon_spec(field, DEFAULT_T, DEFAULT_RATE, DEFAULT_R_F, DEFAULT_R_P)


