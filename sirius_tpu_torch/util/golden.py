"""Canonical accumulator digests — the self-golden-vector regime.

The port's own copy of `sirius_tpu/util/golden.py`, with what the
port's paths use (the port imports nothing of the JAX package).

BASELINE.json's acceptance criterion ("bit-exact folded accumulators vs the
Rust reference") is unfalsifiable in this environment: there is no Rust
toolchain, the reference's accumulator values are computed (not inline) in
its tests, and PARITY.md documents deliberate encoding deviations
(hash_to_curve pipeline, pp-digest serialization, limb geometry).  The
re-scoped criterion (PARITY.md "Bit-exactness scope") is:

  1. primitive-level bit-exactness vs the reference's inline golden vectors
     (Poseidon, FFT, Lagrange — tested in the default suite), and
  2. CROSS-VERSION bit-exactness of folded accumulators for frozen example
     configurations: the digests below must never drift between commits,
     so any unintended change to the transcript, fold arithmetic, layout,
     or hashing shows up as a golden-digest test failure.

The digest is a SHA-256 over a canonical little-endian encoding of every
instance-level accumulator field (witnesses enter via their commitments).
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np


def _enc_int(h, v: int):
    h.update(int(v).to_bytes(64, "little", signed=False))


def _enc_point(h, pt):
    if pt.is_identity:
        _enc_int(h, 0)
        _enc_int(h, 0)
    else:
        _enc_int(h, pt.x)
        _enc_int(h, pt.y)


def sangria_acc_digest(acc_U) -> str:
    """RelaxedPlonkInstance -> hex digest."""
    h = hashlib.sha256()
    for c in acc_U.W_commitments:
        _enc_point(h, c)
    for v in acc_U.consistency_markers:
        _enc_int(h, v)
    for v in acc_U.challenges:
        _enc_int(h, v)
    _enc_point(h, acc_U.E_commitment)
    _enc_int(h, acc_U.u)
    if acc_U.sc_instances_hash_acc is not None:
        _enc_int(h, acc_U.sc_instances_hash_acc)
    return h.hexdigest()


def pg_acc_digest(acc_ins) -> str:
    """protogalaxy.AccumulatorInstance -> hex digest."""
    h = hashlib.sha256()
    for c in acc_ins.ins.W_commitments:
        _enc_point(h, c)
    for inst in acc_ins.ins.instances:
        for v in inst:
            _enc_int(h, v)
    for v in acc_ins.ins.challenges:
        _enc_int(h, v)
    for b in acc_ins.betas:
        _enc_int(h, b)
    _enc_int(h, acc_ins.e)
    return h.hexdigest()


def plonk_trace_digest(W_words, instance) -> str:
    """A plain trace -> hex digest: every W round's Montgomery words ((n, 8)
    32-bit words as numpy arrays, 32 bytes an element, little-endian), then
    the W commitments, the instance columns and the challenges."""
    h = hashlib.sha256()
    for w in W_words:
        h.update(np.ascontiguousarray(np.asarray(w).astype("<u4")).tobytes())
    for c in instance.W_commitments:
        _enc_point(h, c)
    for inst in instance.instances:
        for v in inst:
            _enc_int(h, v)
    for v in instance.challenges:
        _enc_int(h, v)
    return h.hexdigest()


def sangria_ivc_digest(ivc) -> str:
    """A Sangria IVC's state -> hex digest: the step, both sides' z_0 and
    z_i, the pending secondary trace's instances, W commitments and
    challenges, both relaxed instances (`sangria_acc_digest`) and both
    sides' public instances.  Reads only attributes both packages share."""
    h = hashlib.sha256()

    def ints(vs):
        vs = list(vs)
        _enc_int(h, len(vs))
        for v in vs:
            _enc_int(h, v)

    u = ivc.secondary_trace.u
    _enc_int(h, ivc.step)
    for zs in (ivc.primary_z_0, ivc.primary_z_i, ivc.secondary_z_0, ivc.secondary_z_i):
        ints(zs)
    _enc_int(h, len(u.instances))
    for inst in u.instances:
        ints(inst)
    _enc_int(h, len(u.W_commitments))
    for c in u.W_commitments:
        _enc_point(h, c)
    ints(u.challenges)
    for acc in (ivc.primary_relaxed.U, ivc.secondary_relaxed.U):
        h.update(bytes.fromhex(sangria_acc_digest(acc)))
    for pub in (ivc.primary_pub_instances, ivc.secondary_pub_instances):
        _enc_int(h, len(pub))
        for inst in pub:
            _enc_int(h, len(inst))
            for col in inst:
                ints(col)
    return h.hexdigest()


def cyclefold_digests(ivc, W_words) -> tuple[str, str, str]:
    """A Cyclefold IVC's state -> (its ProtoGalaxy accumulator's
    `pg_acc_digest`, its support accumulator's `sangria_acc_digest`, the
    pending primary trace's `plonk_trace_digest` over `W_words`, that
    trace's W rounds as (n, 8) 32-bit words).  Reads only attributes both
    packages share."""
    acc = ivc.self_acc
    acc_ins = SimpleNamespace(ins=acc.trace.u, betas=acc.betas, e=acc.e)
    return (pg_acc_digest(acc_ins), sangria_acc_digest(ivc.support_acc.U),
            plonk_trace_digest(W_words, ivc.primary_trace.u))


# Sangria IVC on `TrivialStepCircuit(1)` both sides, k1 = k2 = 16, mock keys
# (`util/testing.MockCommitmentKey`), z0 = [0x11] / [0x22]: the JAX package's
# `sirius_tpu/ivc/sangria_ivc.py` run on the CPU, frozen.  The pp digest
# points (affine x, y on bn256 and on grumpkin) and `sangria_acc_digest` of
# the (primary, secondary) relaxed instances after `IVC(...)` and after one
# `fold_step()`.
SANGRIA_IVC_K16_PP_DIGEST_1 = (
    9819562387128035433135519526325461625769612566071672557755081981000565151781,
    4909835317067816932168364630470844746129991275860918372998752337402559205112,
)
SANGRIA_IVC_K16_PP_DIGEST_2 = (
    3654089299844383669813660638963876496266822595449127202762804346367441377620,
    5598962449376080124067008313437006056691379627229200826787441529004200697003,
)
SANGRIA_IVC_K16_NEW = (
    "7691f83193259a78ff91363075d579e1541eaf9edadadb0ee2b167393ddb51cf",
    "bcbb0188e4c2e1846f96857824733f8d93ff6e2160b42abdf6306f67a11ff7e5",
)
SANGRIA_IVC_K16_STEP = (
    "ae8fb95fa44177d8bb7205c179d4ab71ebc5ce045becf49774c7e1d8b1a0491f",
    "79735c7f55ccf4423913b841aa40a9842b3fe6169f1079b998a59ef66bed3aae",
)

# The lookup path (2- and 3-round SPS), the JAX package run on the CPU,
# frozen.  `plonk_trace_digest` of the K = 5 traces of tests/test_lookup.py
# (RangeCircuit([3, 7, 15, 0, 1, 1, 5]) and VectorRangeCircuit([2, 3, 5, 7,
# 11]), TABLE 16, key CommitmentKey.setup(BN256_G1, 9, b"lookup-test"), a
# fresh bn256 Fq Poseidon transcript each).
LOOKUP_RANGE_K5_TRACE = "c734eedc58d0974a67e4803839b9240441650e869505de475b9ae85943236ae0"
LOOKUP_VECTOR_K5_TRACE = "dfc5a3713a5b06b395dada023430f590a7bf233b84a6a68d6adcffc0681e2f50"
# tests/test_lookup.py::test_fold_with_lookup: RangeCircuit([3, 7, 15]) and
# RangeCircuit([1, 2, 4, 8]) on one transcript, folded into the zero
# relaxed accumulator one after the other: sangria_acc_digest after each.
LOOKUP_SANGRIA_FOLDS = (
    "6da3351b7a0efa15427ccbbd5c21aa923b77ff6ad981128fd569feac1e64aa3b",
    "36a175bcddb5c0a693ffeb48b5dfe97bf1c5eaca6c8e68e276787a56be642828",
)
# tests/test_protogalaxy.py::test_protogalaxy_fibo_lookup_L1:
# FiboXorLookupCircuit(1, 2, 8) at K = 4, XOR_BITS 2, key
# CommitmentKey.setup(BN256_G1, 7, b"pg-test"), bn256 Fr transcripts: the
# trace, the new accumulator and the accumulator after one fold (the
# verifier's instance has the same digest).
LOOKUP_PG_FIBO_XOR_TRACE = "43a1370a4797952ac8b04becad14bedf323cd91171748127b23e70ad03f97142"
LOOKUP_PG_FIBO_XOR_NEW = "01f1066f4fba8153464cbfb19658118b5b374495926ebb717d2eb5643bc20ea9"
LOOKUP_PG_FIBO_XOR_L1 = "8cd8de45127826e9b83ea061c7c38c86cff0c5e90632c42e864cfd05649d016e"
# __graft_entry__.py:dryrun_multichip's Sangria folds without a mesh
# (`util/testing.dryrun_sangria_folds`; key CommitmentKey.setup(BN256_G1, 9,
# b"dryrun-mc")): sangria_acc_digest after each of the two folds, frozen with
# `JAX_PLATFORMS=cpu python tests/freeze_ivc_digests.py dryrun_mc_folds`
# (90.3 s of JAX on a CPU).
DRYRUN_MC_FOLDS = (
    "6bd55e20d98b3453b44a84f7d7d21396b1e7500d59ff5cd5671b1966481e7039",
    "b9076303dda5ea8d08261e342a19ce1208c761adbb77a1c74742d08f6cb50789",
)


# The lookup IVCs, the JAX package run on the CPU, frozen with
# `JAX_PLATFORMS=cpu python tests/freeze_ivc_digests.py <config>` at commit
# c27e9f32 (its seconds: public parameters / new / next or fold_step, on an
# 8-core CPU host shared with other work).
#
# `xor_lookup` (12.7 / 88.9 / 701.1 s): Cyclefold on
# `XorLookupStepCircuit(key=3)` at k = 18, mock keys, z0 = [2]
# (tests/test_cyclefold.py::test_cyclefold_lookup_step): the pp digest
# (`digest_hex`) and `cyclefold_digests` after new (z = [1]) and after one
# next (z = [2]).
CYCLEFOLD_XOR_LOOKUP_K18_PP = (
    "05c84efc8833e50d20012f9d35076f6ef430149d720cbafa899f3c7a4a539435"
    "0b42866547e6f2e8c05a0d8e6085cd2e0ca219900dfcc9a92d51ce09860af5ba"
)
CYCLEFOLD_XOR_LOOKUP_K18_NEW = (
    "078d7178b37cfa561cff645f4ef2d4efc8df15551b6fddc4d7cf97b0afd1141f",
    "e0084b66cb4a03e2aba6cc7342eead6a91610ad915d66f9ae2c734f99b772ac7",
    "9ff5932d7c23291c471ea6367317fe57272fcbdc276e8964b2c33b2f542560d7",
)
CYCLEFOLD_XOR_LOOKUP_K18_NEXT = (
    "64c468df6b9f19721a2940cb0ce2634d728197b6c396c0b0bfaadacbc8542c29",
    "15a55a28da878c77ac7833855113398bc10f2a1138a51ba3ea2b74212ae0b1bf",
    "58c0752d7f933947c88409b87e69c94c1028128c8d6e344985941c7c9e5031ae",
)
# `sha256` (14.0 / 117.9 / 833.2 s): Cyclefold on the table16-class step at
# its production size, `SpreadSha256StepCircuit(bn256_fr, half_bits=16,
# rounds=64)` at k = 18, mock keys, z0 = [0x0123456789ABCDEF]
# (examples/sha256_table16.py): the pp digest, z after new and after one
# next, and `cyclefold_digests` after each.
CYCLEFOLD_SHA256_K18_PP = (
    "0c650e7ec30805b288edd2cb527de376653143bb367920ecf715751b747d226a"
    "084ba4f4b849b2c8a900a01750a20480d83b579168c45c72fcfc7aa9d4bfe371"
)
CYCLEFOLD_SHA256_K18_Z = (
    0xA5C216996EED7EC634A7B3D5C5783D4A5D67C83BF5899A511E36DC48E2212F7,
    0x1FEF87B3F4FD2CA0104D0D361943449023678CDC2AA35CF6C7877ADBBC674EA,
)
CYCLEFOLD_SHA256_K18_NEW = (
    "030e5f0bcd01f5d5bef791c044ee87593055c0fbde1fcfa186d3683c543dcbe5",
    "e0084b66cb4a03e2aba6cc7342eead6a91610ad915d66f9ae2c734f99b772ac7",
    "8d8264547cd1257daf7fb95dd65f0223fb262045a09cff769876a9035afb70ad",
)
CYCLEFOLD_SHA256_K18_NEXT = (
    "fb55c98d09d1192fc15266b655cc18e85e1f710ad0d3c35c72a97a03f1868621",
    "2ef23dae1bc044841d3d6c36cc6d410449c6779cbe82d08b039ad9a327af82d3",
    "251cbb13dec8fec04760b2bfa87fa0668892c52b32060c44dc7215cade375ec1",
)
#
# `sangria_range` (10.6 / 32.0 / 289.6 s; the `*_STATE` digests in a second
# run at the same commit, 12.8 / 26.5 / 310.0 s, which gave the same other
# digests): Sangria IVC on `RangeCheckStepCircuit(bn256_fr)` (a 2-round SPS)
# against `TrivialStepCircuit(1)`, k = 17 on both curves, mock keys, z0 =
# [7] / [0] (tests/test_sangria_ivc.py::test_sangria_ivc_lookup_step): the
# pp digest points, `sangria_acc_digest` of the (primary, secondary)
# relaxed instances and `sangria_ivc_digest` of the whole state after
# `IVC(...)` and after one `fold_step()`, and z after it.
SANGRIA_IVC_RANGE_K17_PP_DIGEST_1 = (
    16893478130312140726241175082800399879792409684123213921016641343880821977742,
    16027696265880813389819205701653660978905763993734285828052312339764968948532,
)
SANGRIA_IVC_RANGE_K17_PP_DIGEST_2 = (
    19321728188301600683829389873098372382614419731205775260502747762232867722075,
    15905766510489316468553934702798982302850234856111608011777784106600723689523,
)
SANGRIA_IVC_RANGE_K17_NEW = (
    "da9bb8c0fb77132d6e1bb71f52fcb21b5a8e026e9c812c1cabff6f846ce42d49",
    "166cad9d7dcb93e4209756f5234d73a9c72ea667338d262bcba554bb6bbca967",
)
SANGRIA_IVC_RANGE_K17_STEP = (
    "2ce95879558dcf249c5a62183e42ee435756fb4b51efa8080e29d43ac696647f",
    "6064755ba7e8ef6e90516520538a22af473d408a1d8fed5a7c627f8f70ada4c6",
)
SANGRIA_IVC_RANGE_K17_Z = 0xECB
SANGRIA_IVC_RANGE_K17_NEW_STATE = "8a64e4b91cf97bd4142d094c400d894e0be730e4028b51e13f852cd95c72d04b"
SANGRIA_IVC_RANGE_K17_STEP_STATE = "4443606351c740de385c444e65ec8d3f61fa1c6a8976740c46327b25ea4cf69d"
#
# `sangria_xor` (8.7 / 29.9 / 292.8 s): the same with
# `XorStepCircuit(bn256_fr)` (a vector lookup: a 3-round SPS), z0 = [5] / [0]
# (tests/test_sangria_ivc.py::test_sangria_ivc_vector_lookup_step).
SANGRIA_IVC_XOR_K17_PP_DIGEST_1 = (
    10328824175401019305913518591690133200683437783911211957006229961589578020604,
    9468108719063478410808337194647508129223154505964000261628472271360852129909,
)
SANGRIA_IVC_XOR_K17_PP_DIGEST_2 = (
    18501334501246938010068963105288251667862915745598919288493891609526063809267,
    4679637402358219490460924422925699927005768852966388525663029595018947469442,
)
SANGRIA_IVC_XOR_K17_NEW = (
    "8889ce1f22be17f1db4a1f066e34dc4e2fc0ffed209c1dd14048a454de6cf151",
    "4a2b4e10c97a532b9e0b457aadeea570836bc7d9bda872cc839c0f64b0746e44",
)
SANGRIA_IVC_XOR_K17_STEP = (
    "0246603295df29b2ba003fe83c9a49d1bd948f206340db5296c9461297d15882",
    "a29ad3d8a07b94436a2278bef03ac214f9bafbd5be1d917421aff06bc14a5394",
)
SANGRIA_IVC_XOR_K17_Z = 0x14


# The slice of the examples and the checkpoint, the JAX package run on the
# CPU, frozen with `JAX_PLATFORMS=cpu python tests/freeze_ivc_digests.py
# <config>` at commit c5ee30b5 (its seconds: public parameters / new / next
# or fold_step, four configurations at once on an 8-core CPU host shared
# with other work).
#
# `cyclefold_trivial_k17` (3.3 / 35.9 / 160.2 s): Cyclefold on
# `TrivialStepCircuit(1)` at k = 17, mock keys, z0 = [0x11]
# (examples/cyclefold_trivial.py, tests/test_cyclefold.py::
# test_cyclefold_checkpoint_resume): the pp digest and `cyclefold_digests`
# after new and after one next (z stays [0x11]).
CYCLEFOLD_TRIVIAL_K17_PP = (
    "2e2cd213ad5d68116c555cbb79e1bf54acc237d1eea209d53eee05801c825789"
    "1f5aa983726aac5283ff1c0fcaa1e029afb68661736eb6c634322715342100d8"
)
CYCLEFOLD_TRIVIAL_K17_NEW = (
    "d932b526fcae6e1620c7d4a11ef5f75936e753df9fdff18ace3f779b0381a4e7",
    "e0084b66cb4a03e2aba6cc7342eead6a91610ad915d66f9ae2c734f99b772ac7",
    "e19cedcd434ca9b3bffa13999d667ea712a97a7c240ad5ef24dc42e2a00cd4b4",
)
CYCLEFOLD_TRIVIAL_K17_NEXT = (
    "8e97f9e2fd0cf349ca29eeae0b096f59d325bd7f2a942d227182103839361f1d",
    "ef04e64b2f89f941f0c9f08dadf1da850391f7e53bed1809fb6fc80203fdd160",
    "6c86edd55f5193e113b2a63506804a2bf776ea3a3fd17a60d251b39e0ea94e4d",
)
#
# `merkle_d32_b1` (5.7 / 64.8 / 203.8 s): Cyclefold on
# `MerkleStepCircuit(bn256_fr, depth=32, batch=1)` at k = 17, mock keys, z0 =
# [the empty depth-32 tree's root] (examples/merkle_tree.py's defaults): the
# pp digest, z and `cyclefold_digests` after new and after one next.
MERKLE_D32_B1_K17_PP = (
    "092e4170a2e6dea10494117abed771a3e912c0cbbf9f4cda2716b61ff01d37dd"
    "0a1081f7ca4afe18eeb999a86df56670d86340fe08a0cb2c059472265048ebc0"
)
MERKLE_D32_B1_K17_Z = (
    0x2E2396F74D0BF130DBEF4B73D32EA5F822E25D41CB25F6587EE25F57FC31D603,
    0x120E997DC8350C8EF6711414A0A7C1119DDDCDDE7AC91F41B614314A9004CF26,
)
MERKLE_D32_B1_K17_NEW = (
    "c2046a8dca19f1803136053f99bbc9f126f587689338f0be444de7348daf20e6",
    "e0084b66cb4a03e2aba6cc7342eead6a91610ad915d66f9ae2c734f99b772ac7",
    "0af59bbdb021d1eafffbded5ff1b6cbea0bb1b3ad2ff2eeee3149d859d167f16",
)
MERKLE_D32_B1_K17_NEXT = (
    "1511087e97d00f6522c8cae42d97aa6340695b71b45d10b2eec1a9cb9f554e65",
    "84401afd86d9f9230cc765005aaa57612846519d6399bcc3bf713c2f62b681e7",
    "4e6c1165c5d2097d00448c84d670b285b985902e9f5e2b848f331666db4a8db4",
)
#
# `sangria_instances` (7.4 / 3.8 / 179.2 s): Sangria IVC on examples/
# instances.py's `PublicPow5Circuit` (z' = z^5, exposed in its own instance
# column, hash-chained into `sc_instances_hash_acc`) against
# `TrivialStepCircuit(1)`, k = 16 on both curves, mock keys, z0 = [3] / [0]:
# the pp digest points, `sangria_acc_digest` of the (primary, secondary)
# relaxed instances and `sangria_ivc_digest` after `IVC(...)` and after one
# `fold_step()`, then z and the primary's `sc_instances_hash_acc`.
SANGRIA_INSTANCES_K16_PP_DIGEST_1 = (
    19019851256773811989481691017009792073652431562123179265387647664688339279858,
    7126667912641280005393568394242678876494080053801606414810508251175874180322,
)
SANGRIA_INSTANCES_K16_PP_DIGEST_2 = (
    9479486455428602293979361398397273575096958070987585472625123461322095502337,
    3646220057597257532806832987890037754596597145967209821296652881429664718147,
)
SANGRIA_INSTANCES_K16_NEW = (
    "d3f995478e7abdbf071376a94943cb243d6e07365b0297681a276b7df290dab7",
    "b6b0465811f8bda06da6329c683c5a88031b2a01e29058ad7fa9a5c086801cab",
)
SANGRIA_INSTANCES_K16_NEW_STATE = "d7a78230ca8d960c42a190a4a69039220f8a5ba53e1023f842d084c9b2eb9792"
SANGRIA_INSTANCES_K16_STEP = (
    "20df963af3070f89cfffe2a0fc091376e02230702c5ce274d16e3636dedc5ead",
    "a5d7be5ca24c173ec58c044f7a4dce86550ff695b5c49d91f537ade811ee0ad5",
)
SANGRIA_INSTANCES_K16_STEP_STATE = "dd5eaece1b83a3550b5e8f17669c2ccb795ac14c795d8cb51f86bb6b6a0be237"
SANGRIA_INSTANCES_K16_Z = 0xC546562AA3  # 3^25
SANGRIA_INSTANCES_K16_SC_HASH = 0x2CB11BC3E76FAA00CE196617D6FB93630BD5D10CFAD75257803FF8CE82876494
#
# `my_circuit` (7.1 / 4.0 / 181.7 s): the same with examples/my_circuit.py's
# arity-5 `MyStepCircuit` (z'_j = z_j + z_{(j+1) mod 5}), z0 = [0, 1, 2, 3, 4]
# / [0] (no instance column of its own: `sc_instances_hash_acc` is None).
MY_CIRCUIT_K16_PP_DIGEST_1 = (
    20992666329717042311859498072739398172144030307592229086337506833875776900430,
    21324955093657456837631045613277356916240416529994963314005709077148735145674,
)
MY_CIRCUIT_K16_PP_DIGEST_2 = (
    13388088394757903434682744876690708108911681781644781019532415442882999107593,
    21439931928705111725865651125020213001114336308417341823978898823477700692660,
)
MY_CIRCUIT_K16_NEW = (
    "02efc2abddc40144154b7ae139285a118a7ae814cfb7704fea638dd9a0bcc38a",
    "d3781c8a729fd082d69604e41a080757e8556461ce7c314b5dd2852efb1c3f98",
)
MY_CIRCUIT_K16_NEW_STATE = "4489015b9297fa26994df6b358232e8551f9ead005825d32a8038232bdfb3724"
MY_CIRCUIT_K16_STEP = (
    "a4c1498313d15305a16a7ac30fbc5c8626a1665ba53f2674e9ff1365e03ee9fd",
    "c7ace7d319d0fbd8eedd5a94e4d121b4195e8329ec94e7abe6e2643f2211b9d3",
)
MY_CIRCUIT_K16_STEP_STATE = "b800c237333d613ca833229e621ee889930bfbf1aac487049092f4d88a418f94"
MY_CIRCUIT_K16_Z = (4, 8, 12, 11, 5)
