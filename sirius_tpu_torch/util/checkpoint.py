"""Accumulator checkpoint and resume.

The port's counterpart of `sirius_tpu/util/checkpoint.py`, in the same file
format, so a checkpoint written by either package loads in the other: the
instance side as `<path>.json` (the same keys, points as {inf, x, y} with hex
coordinates, field elements as hex) and the witness arrays as `<path>.npz`
(the same names, each (n, 16) uint32 16-bit Montgomery limbs, the JAX
package's layout; both packages use R = 2^256, so the port's (n, 8) 32-bit
words repack to the same values, `util/interop.words_to_limbs`).  Every
checkpoint is keyed by the public-parameter digest: a load with another
digest raises ValueError, so a resume cannot mix incompatible set-ups.

The loaders put the witness tensors on `device`, the CUDA device when none is
given (`util/device.resolve`: a machine without one raises unless the caller
passes device="cpu").  Row-block rounds (`parallel/rows.py`) are written
gathered, the same bytes as a single device's, and a load under an active
mesh that divides the rows cuts them into row blocks again.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..fields import gold
from ..fields.constants import CURVES, CurveSpec, bn256_g1, grumpkin
from ..nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness
from ..parallel.rows import gathered, place
from ..plonk.structure import PlonkInstance, PlonkTrace, PlonkWitness
from .device import resolve
from .interop import limbs_to_words, words_to_limbs


def _point_to_json(pt) -> dict:
    return {"inf": pt.is_identity, "x": hex(pt.x or 0), "y": hex(pt.y or 0)}


def _point_from_json(curve: CurveSpec, d: dict) -> gold.AffinePoint:
    if d["inf"]:
        return gold.identity(curve)
    return gold.AffinePoint(curve, int(d["x"], 16), int(d["y"], 16))


def _hexes(values) -> list[str]:
    return [hex(v) for v in values]


def _ints(hexes) -> list[int]:
    return [int(v, 16) for v in hexes]


def _words(data, name: str, device, n: int):
    """A (size, 16) limb array of the npz -> a (size, 8) word tensor on
    `device`, or its row blocks under the row mesh of n table rows."""
    return place(torch.from_numpy(limbs_to_words(data[name])).to(device), n)


def _relaxed_to_json(U: RelaxedPlonkInstance) -> dict:
    return {
        "W_commitments": [_point_to_json(c) for c in U.W_commitments],
        "consistency_markers": _hexes(U.consistency_markers),
        "challenges": _hexes(U.challenges),
        "E_commitment": _point_to_json(U.E_commitment),
        "u": hex(U.u),
        "sc_hash_acc": None if U.sc_instances_hash_acc is None else hex(U.sc_instances_hash_acc),
    }


def _relaxed_from_json(curve: CurveSpec, d: dict) -> RelaxedPlonkInstance:
    return RelaxedPlonkInstance(
        W_commitments=[_point_from_json(curve, c) for c in d["W_commitments"]],
        consistency_markers=_ints(d["consistency_markers"]),
        challenges=_ints(d["challenges"]),
        E_commitment=_point_from_json(curve, d["E_commitment"]),
        u=int(d["u"], 16),
        sc_instances_hash_acc=None if d["sc_hash_acc"] is None else int(d["sc_hash_acc"], 16),
    )


def _instance_to_json(u: PlonkInstance) -> dict:
    return {
        "W_commitments": [_point_to_json(c) for c in u.W_commitments],
        "instances": [_hexes(inst) for inst in u.instances],
        "challenges": _hexes(u.challenges),
    }


def _instance_from_json(curve: CurveSpec, d: dict) -> PlonkInstance:
    return PlonkInstance([_point_from_json(curve, c) for c in d["W_commitments"]],
                         [_ints(inst) for inst in d["instances"]], _ints(d["challenges"]))


def _read_meta(path: str, pp_digest_hex: str) -> dict:
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["pp_digest"] != pp_digest_hex:
        raise ValueError(f"checkpoint pp digest {meta['pp_digest']} != expected {pp_digest_hex}")
    return meta


def _write(path: str, meta: dict, arrays: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    np.savez(path + ".npz", **{name: words_to_limbs(gathered(t)) for name, t in arrays.items()})


def save_sangria_accumulator(path: str, curve: CurveSpec, acc: RelaxedPlonkTrace, pp_digest_hex: str, step: int):
    """A Sangria relaxed accumulator: the instance as JSON, W rounds and E
    as npz (`W{i}`, `E`)."""
    meta = {"pp_digest": pp_digest_hex, "step": step, "curve": curve.name, **_relaxed_to_json(acc.U)}
    _write(path, meta, {"E": acc.W.E, **{f"W{i}": w for i, w in enumerate(acc.W.W)}})


def load_sangria_accumulator(path: str, pp_digest_hex: str, device=None) -> tuple[RelaxedPlonkTrace, int]:
    """(accumulator, step) of a Sangria checkpoint; raises ValueError on a
    pp-digest mismatch."""
    meta = _read_meta(path, pp_digest_hex)
    device = resolve(device)
    U = _relaxed_from_json(CURVES[meta["curve"]], meta)
    with np.load(path + ".npz") as data:
        n = data["E"].shape[0]
        W = RelaxedPlonkWitness([_words(data, f"W{i}", device, n) for i in range(len(U.W_commitments))],
                                _words(data, "E", device, n))
    return RelaxedPlonkTrace(U, W), meta["step"]


def save_cyclefold_state(path: str, ivc, pp_digest_hex: str):
    """The whole state of a Cyclefold IVC: the ProtoGalaxy accumulator
    (instance, witness, betas, e), the support Sangria accumulator and the
    public instances of every support trace folded so far, the pending
    primary trace, the step counter and z_0 / z_i.  The support chain's
    per-fold instances and cross-term commitments (`SupportFoldChain.incoming`
    and `.cross`) are not part of the JAX package's format and are not
    saved."""
    acc, sup = ivc.self_acc, ivc.support_acc
    meta = {
        "pp_digest": pp_digest_hex,
        "step": ivc.step,
        "z_0": _hexes(ivc.z_0),
        "z_i": _hexes(ivc.z_i),
        "pg_u": _instance_to_json(acc.trace.u),
        "pg_betas": _hexes(acc.betas),
        "pg_e": hex(acc.e),
        "primary_u": _instance_to_json(ivc.primary_trace.u),
        "support_U": _relaxed_to_json(sup.U),
        "support_pub_instances": [[_hexes(col) for col in insts] for insts in ivc.support_pub_instances],
    }
    _write(path, meta, {
        "supE": sup.W.E,
        **{f"pgW{i}": w for i, w in enumerate(acc.trace.w.W)},
        **{f"priW{i}": w for i, w in enumerate(ivc.primary_trace.w.W)},
        **{f"supW{i}": w for i, w in enumerate(sup.W.W)},
    })


def load_cyclefold_state(path: str, pp, pp_digest_hex: str, device=None):
    """A `CyclefoldIVC` on public parameters `pp` that continues from a
    checkpoint; raises ValueError on a pp-digest mismatch.  The support chain
    is rebuilt from `pp` (its folding parameters from the pp digest and the
    support structure) and takes the saved accumulator and public instances;
    its `incoming` and `cross` lists restart empty, so `next` runs on from
    here while `SupportFoldChain.verify()` replays only the folds made after
    the resume."""
    from ..ivc.cyclefold_ivc import CyclefoldIVC
    from ..ivc.support_fold import SupportFoldChain
    from ..nifs.protogalaxy import Accumulator

    meta = _read_meta(path, pp_digest_hex)
    device = resolve(device)
    ivc = CyclefoldIVC.__new__(CyclefoldIVC)
    ivc.pp = pp
    ivc.step = meta["step"]
    ivc.z_0, ivc.z_i = _ints(meta["z_0"]), _ints(meta["z_i"])
    pg_u = _instance_from_json(bn256_g1, meta["pg_u"])
    pri_u = _instance_from_json(bn256_g1, meta["primary_u"])
    sup_U = _relaxed_from_json(grumpkin, meta["support_U"])
    n, sup_n = pp.S_primary.n, pp.S_support.n
    with np.load(path + ".npz") as data:
        pg_w = PlonkWitness([_words(data, f"pgW{i}", device, n) for i in range(len(pg_u.W_commitments))])
        pri_w = PlonkWitness([_words(data, f"priW{i}", device, n) for i in range(len(pri_u.W_commitments))])
        sup_W = RelaxedPlonkWitness([_words(data, f"supW{i}", device, sup_n)
                                     for i in range(len(sup_U.W_commitments))], _words(data, "supE", device, sup_n))
    ivc.self_acc = Accumulator(PlonkTrace(pg_u, pg_w), _ints(meta["pg_betas"]), int(meta["pg_e"], 16))
    ivc.primary_trace = PlonkTrace(pri_u, pri_w)
    ivc.support = SupportFoldChain(pp.ck2, pp.S_support, pp.support_taped, pp_digest=pp.digest)
    ivc.support.acc = RelaxedPlonkTrace(sup_U, sup_W)
    ivc.support.pub_instances = [[_ints(col) for col in insts] for insts in meta["support_pub_instances"]]
    return ivc
