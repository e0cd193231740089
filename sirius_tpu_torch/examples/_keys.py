"""Commitment-key selection for the examples: the port's `example_keys`
(counterpart of `examples/_keys.py`).

Real Pedersen keys (`CommitmentKey.setup` on the device, the reference's
always-real configuration, `src/commitment.rs:81-90`) unless the example was
asked for the CPU; then the non-binding `MockCommitmentKey` on the CPU, so
the examples run there in minutes.  The labels and sizes are the JAX
package's (`<label>-primary`, `<label>-support`), so both packages derive
the same points, with one repair: most JAX examples size their primary key
below their own step-folding circuit's first W round (at k = 17 the
Merkle, Poseidon and SHA-256 steps commit 14 advice columns, 1,835,008
scalars, to a 2^20 key; `CommitmentKey.commit` raises TooLongInput there),
so on real keys the primary key grows to the smallest power of two that
holds the example's largest W round (`largest_w_round`), and says so.
"""

from __future__ import annotations


def largest_w_round(step_circuit, k: int, driver: str = "cyclefold") -> int:
    """Scalars in the largest W round of the primary step-folding circuit of
    `driver` ("cyclefold" or "sangria") over `step_circuit` at 2^k rows, from
    a configure-only pass (no synthesis)."""
    from ..fields.constants import bn256_fr, grumpkin
    from ..frontend.circuit import ConstraintSystemBuilder
    from ..frontend.runner import ConstraintSystemMetainfo

    if driver == "cyclefold":
        from ..ivc.cyclefold_ivc import CyclefoldSFC

        sfc = CyclefoldSFC(step_circuit, None, bn256_fr)
    else:
        from ..ivc.sangria_ivc import StepFoldingCircuit

        sfc = StepFoldingCircuit(step_circuit, None, grumpkin, bn256_fr)
    cs = ConstraintSystemBuilder()
    sfc.configure(cs)
    return max(ConstraintSystemMetainfo.build(k, cs).round_sizes)


def example_keys(k_primary: int, k_support: int | None = None, label: str = "example", cpu: bool = False,
                 device=None, holds: int = 0):
    """(primary key, support key, "real" | "mock"): bn256 2^k_primary and
    grumpkin 2^k_support (k_primary when None) keys on `device` (the CUDA
    device when None), the primary raised to hold `holds` scalars; or mock
    keys on the CPU when `cpu`."""
    from ..curves.jpoint import BN256_G1, GRUMPKIN

    if cpu:
        from ..util.testing import MockCommitmentKey

        return MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu"), "mock"

    from ..ops.commitment import CommitmentKey

    k2 = k_support if k_support is not None else k_primary
    k1 = max(k_primary, (holds - 1).bit_length())
    if k1 > k_primary:
        print(f"primary key 2^{k1}: the JAX example's 2^{k_primary} cannot hold the step-folding circuit's W round "
              f"of {holds} scalars")
    ck1 = CommitmentKey.setup(BN256_G1, k1, f"{label}-primary".encode(), device=device)
    ck2 = CommitmentKey.setup(GRUMPKIN, k2, f"{label}-support".encode(), device=device)
    return ck1, ck2, "real"
