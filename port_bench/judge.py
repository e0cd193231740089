"""The comparison that decides `correct`: the plain reference judges the
chain that the program's timed path left behind.

The reference is `reference/sirius_plain`: the verifier's half of the
port's plain code, frozen, with every kernel replaced by its plain torch
twin; it imports nothing of the program.  Its logic is the port's own, so
two checks hold it to code the port did not write: its pp digest against
the JAX package's, frozen in the configuration (`pp_digest_off`), and, in
`port_bench/tests/`, its verdicts against the JAX package's verifier on
the trivial configuration.  After the window it:

- rebuilds the public parameters from the configuration alone (its own
  dry syntheses of both circuits' structures and the pp digest over them)
  and compares the digest with the JAX package's;
- reads the commitment keys from the checkout's key cache with its own
  loader, and hashes its own key points, by its host hash-to-curve, for a
  sample of indices drawn from the seed (the keys are the one input both
  sides read; this checks that they are the labels' keys);
- runs the IVC verifier over the program's chain as the window left it:
  the marker that binds (pp digest, step, z_0, z_i, both accumulators), the
  relaxed relation of the ProtoGalaxy accumulator, the Sangria support
  accumulator and the pending primary trace, and every commitment of the
  primary side against the key (one random-linear-combination MSM);
- counts the steps the chain took and computes z_step = F^step(z_0) with
  its own step function.

Each check is a count with the limit 0: an exact comparison.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from .harness import step_circuit

REF = "port_bench.reference.sirius_plain"
KEY_SAMPLES = 8  # key points a key hashes again, besides its first and last


@dataclass
class Check:
    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def reference_keys(cfg: dict, device):
    """The two keys as the reference loads them from the key cache."""
    from .reference.sirius_plain.curves.jpoint import BN256_G1, GRUMPKIN
    from .reference.sirius_plain.ops.commitment import CommitmentKey, _load_cached

    curves = {"bn256": BN256_G1, "grumpkin": GRUMPKIN}
    out = []
    for key in (cfg["primary_key"], cfg["support_key"]):
        curve, label = curves[key["curve"]], key["label"].encode()
        path = CommitmentKey.cache_file(curve, key["log2_size"], label)
        out.append(CommitmentKey(curve, _load_cached(curve, path, device), label, key["log2_size"]))
    return tuple(out)


def key_points_off(ck, rng: np.random.Generator, samples: int = KEY_SAMPLES) -> int:
    """How many of a sample of the key's points (its first, its last and
    `samples` drawn from `rng`) differ from the reference's host
    hash-to-curve of the label's SHAKE-256 stream."""
    from .reference.sirius_plain.curves.hash_to_curve import hash_bytes_to_point
    from .reference.sirius_plain.curves.jpoint import Points

    n = len(ck)
    idx = sorted({0, n - 1, *(int(i) for i in rng.integers(0, n, size=samples))})
    stream = hashlib.shake_256(ck.label).digest(64 * (idx[-1] + 1))
    sel = Points(*(c[idx] for c in ck.points))
    got = ck.curve.decode(sel)
    return sum(1 for i, p in zip(idx, got) if p != hash_bytes_to_point(ck.curve.spec, stream[64 * i: 64 * i + 64]))


def _point(spec, xy):
    from .reference.sirius_plain.fields import gold

    return gold.identity(spec) if xy is None else gold.AffinePoint(spec, xy[0], xy[1])


def reference_chain(pp, state: dict):
    """The reference's `CyclefoldIVC` holding the program's chain state."""
    from .reference.sirius_plain.fields.constants import bn256_g1, grumpkin
    from .reference.sirius_plain.ivc.cyclefold_ivc import CyclefoldIVC
    from .reference.sirius_plain.ivc.support_fold import SupportFoldChain
    from .reference.sirius_plain.nifs.protogalaxy import Accumulator
    from .reference.sirius_plain.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness
    from .reference.sirius_plain.plonk.structure import PlonkInstance, PlonkTrace, PlonkWitness

    def instance(u):
        return PlonkInstance([_point(bn256_g1, c) for c in u["W"]], [list(r) for r in u["instances"]],
                             list(u["challenges"]))

    self_acc = Accumulator(PlonkTrace(instance(state["pg_u"]), PlonkWitness(list(state["pg_W"]))),
                           list(state["pg_betas"]), state["pg_e"])
    primary_trace = PlonkTrace(instance(state["pri_u"]), PlonkWitness(list(state["pri_W"])))
    U = state["sup_U"]
    support_acc = RelaxedPlonkTrace(
        RelaxedPlonkInstance([_point(grumpkin, c) for c in U["W"]], list(U["markers"]), list(U["challenges"]),
                             _point(grumpkin, U["E"]), U["u"], U["sc_hash"]),
        RelaxedPlonkWitness(list(state["sup_W"]), state["sup_E"]))
    support = SupportFoldChain(pp.ck2, pp.S_support, support_acc,
                               [[list(col) for col in insts] for insts in state["sup_pub"]])
    return CyclefoldIVC(pp, state["step"], state["z_0"], state["z_i"], self_acc, primary_trace, support)


def reference_params(cfg: dict, keys):
    from .reference.sirius_plain.ivc.cyclefold_ivc import CyclefoldPublicParams

    return CyclefoldPublicParams(step_circuit(cfg, REF), cfg["k"], *keys)


def expected_z(cfg: dict, z0: list[int], steps: int) -> list[int]:
    """F^steps(z_0) by the reference's step function."""
    from .reference.sirius_plain.fields.constants import bn256_fr

    sc = step_circuit(cfg, REF)
    z = [v % bn256_fr.modulus for v in z0]
    for _ in range(steps):
        z = sc.process_step(z, cfg["k"], bn256_fr)
    return z


def judge(cfg: dict, state: dict, z0: list[int], expected_step: int, seed: int, device, keys=None,
          pp=None) -> list[Check]:
    """The checks of one run.  `keys` / `pp` replace the reference's own
    (tests on the CPU pass doubles and share one pp between runs)."""
    rng = np.random.default_rng([seed, 1])
    checks = []
    if keys is None:
        keys = reference_keys(cfg, device)
        checks.append(Check("key_points_off", sum(key_points_off(ck, rng) for ck in keys), 0))
    pp = pp or reference_params(cfg, keys)
    checks.append(Check("pp_digest_off", int(pp.digest_hex() != cfg["pp_digest_jax"]), 0))
    checks.append(Check("step_off", abs(state["step"] - expected_step), 0))
    want = expected_z(cfg, z0, expected_step)
    z_off = sum(a != b for a, b in zip(state["z_i"], want)) + abs(len(state["z_i"]) - len(want))
    z_off += sum(a != b for a, b in zip(state["z_0"], expected_z(cfg, z0, 0)))
    checks.append(Check("z_off", z_off, 0))
    errors = reference_chain(pp, state).verify()
    checks.append(Check("verify_errors", len(errors), 0))
    return checks
