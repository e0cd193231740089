"""Test doubles for the benchmark's CPU tests."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReferenceMockKey:
    """The reference's side of the program's `MockCommitmentKey`: commit(w) =
    sum(w) G, non-binding, on the CPU (what the program's double computes,
    in the reference's own field and curve code)."""

    curve: object  # a reference `curves.jpoint.Curve`
    device: str = "cpu"
    max_len: int = 1 << 40

    def __len__(self):
        return self.max_len

    def commit_device(self, w_mont):
        from port_bench.reference.sirius_plain.fields import gold

        f = self.curve.fs
        s = f.decode_one(f.sum_reduce(w_mont)) if w_mont.shape[0] else 0
        return gold.generator(self.curve.spec).mul(s)

    def batched_commit_check(self, pairs) -> list[int]:
        return [i for i, (W, C) in enumerate(pairs) if self.commit_device(W) != C]


def reference_mock_keys():
    from port_bench.reference.sirius_plain.curves.jpoint import BN256_G1, GRUMPKIN

    return ReferenceMockKey(BN256_G1), ReferenceMockKey(GRUMPKIN)


def program_mock_keys():
    from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    return MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu")
