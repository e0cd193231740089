#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`sirius_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card, its power limit, SM clock and the torch version;
   builds the CUDA kernels from `sirius_tpu_torch/csrc/` (nvcc, sm_90a) into
   one cached library.  S4: x + 1 on an (8, 128) tile, and a second Python
   process must load the cached library without running nvcc; the
   wrapper's host time per call, the device time per launch from a CUDA
   graph of 200 launches (a launch's latency: the tile is one block's
   work) and `x32 + 1` on int32 words, the one PyTorch call computing it.
   S2/S3: the Montgomery-multiply rate (K = 8 chains on 2^17 bn256 Fr and Fq
   elements, bit-exact against the twin, the device time per launch from a
   CUDA graph of 50 launches, back to back beside) on the unrolled C++
   product (the NTT's elementwise multiply), on the PTX carry-chain product
   (B1's walk, B2, B4) and on the wide product (B1's batched madd), every
   product on the edge values 0, 1, p - 1, R mod p, every product's K > 1
   instance's registers and spills, and the raw
   u32 multiply/add rates (2^22 int32-held words x 64 and x 4096), each
   as a share of the paper rate in the instructions the card issues (the
   op's opcode in the SASS per multiply of the mul chain: ptxas fuses two
   dependent adds into one IADD3) for the card's max SM clock and the SM
   clock read under the long chain, and the PyTorch calls that fold each chain (`a32 ** 65`,
   `a32 * 65`), checked bit-equal; the latency probe: one element, K = 1024
   chained products, on each of the port's five products (unrolled,
   rolled, carry-chain, rolled carry-chain: B3's, wide), microseconds per
   product.
2. Keys: the bn256 2^22 key (b"bench-primary"; its first 2^20 points are the
   bn256 key of every phase before 11, the same points as a 2^20 setup) and
   the grumpkin 2^20 key (b"bench-support"), derived on the device in chunks of
   `DEVICE_SETUP_CHUNK` points, each setup's seconds, peak device memory
   (`max_memory_allocated` after `reset_peak_memory_stats`) and the host
   seconds of its square roots (span `h2c_sqrt`); the grumpkin key's first
   2^17 points are the support key of the Cyclefold phases (a SHAKE-256
   stream over the label: the same points as a 2^17 setup).
3. Holds every kernel against its plain torch twin on the card, on the same
   inputs: B1 madd bit-exact on 2^16 pairs per curve and at the cross-term
   step shape (timed from a CUDA graph, beside its bytes at the int64
   words; off the main path since msm_many walks its buckets in one
   launch); best_msm's stages (B2's bucket sort equal to
   bucket_plan_plain, B2 accumulate and every B3 reduce level bit-exact,
   the B3 window sums and combine in affine form) at the support W-commit
   shape, with kernel and twin timed there, each beside its bound and the
   serial floor of its longest dependent chain; the B3 combine at
   msm_many's shape (5, 64, 15) the same way; best_msm at 2^12 against the
   big-integer reference; B1's bucket walk `madd_buckets` bit-exact and
   timed at msm_many's cross-term shape (5 x 2^14), and msm_many (one
   madd_buckets launch, no madd launch) against best_msm (B2/B3 path).
4. Commits 2^20 bn256 scalars (drawn as bench.py draws them): reference
   check on a 64-point prefix, every stage against its twin at 2^20, the
   result against best_msm's, then the points/s of one warm MSM.
5. The NTT at 2^20 on bn256 Fr (bench.py's inputs): B4 at both pass
   shapes (1024 x 1024, forward and inverse tables), its epilogue pass
   (times the mid twiddle, transposed; also equal to col_ntt -> mul_rows ->
   transpose on the card) and `mul_rows` at K = 1 at the shapes the NTT
   path gives it (the coset powers: 2^20 rows against 3, and a doubling
   step of the mid twiddle's build: 2^19 rows against 1024) and over 2^20
   rows against 2^20 (rep = 1) and 2^18 (rep = 4), bit-exact against their
   twins and timed beside their bounds; then
   the NTT path (launch counts from here): mid-twiddle set-up timed apart,
   the forward and the inverse transform must each launch exactly 2
   col_ntt (one its epilogue pass) and no mul_rows, round trips of the
   transforms and of the coset transforms exact, spot values equal to the
   direct sums, k = 3 equal to the reference vector (the R = 1 route),
   k = 12 equal to `gold.fft`, the warm forward transform in elements/s and
   the warm forward and inverse on CUDA events; col_ntt, its epilogue pass
   and mul_rows (the coset powers) must have launched.
6. Drives the Cyclefold support-fold chain: 2 Sangria folds of the EC
   co-processor circuit at k = 14 on the grumpkin key; verify must replay
   the prover's accumulator, is_sat must be clean and must catch a flipped
   witness cell; every kernel must have launched on this path.  The
   support tape's sizes and the seconds of the dry synthesis that traces
   it; one witness by native replay and by direct synthesis, equal word
   for word, both timed (each fold's phases from its spans).  Then one
   more fold runs under torch.profiler: its device events and the device's
   busy share of its wall time.
7. The main path, `bench.py:166-210`'s headline: `CyclefoldIVC` on the
   trivial step circuit at k = 17 with the two keys above: public
   parameters, new, two next (the second folds a non-base-case step),
   verify() == [] and z_i unchanged; seconds of each and the spans of
   `util/profiling` per step; both accumulators' digests; B1's bucket walk,
   B2's sort and accumulate (on both curves' commits, the sort at the
   primary W commit's 917,504 points) and B3 must have launched on this
   path, and the per-step madd must not have; the digests must start
   9f3739df / 13a63ce4, as every earlier run of this path.  The SFC and
   support tapes' sizes (ops, inputs, constants, output slots) beside pp;
   the last next's SFC witness (a native replay) equal word for word to a
   second replay and to direct synthesis of the same inputs, both timed;
   `mul_rows` K = 1 as the SPS's W conversion (917,504 packed words times
   R^2, nb = 1) against its plain version, `Field.to_mont_words` and the
   pending trace's W round, timed beside its bound and the packed upload
   (entry `mul_rows_to_mont`, the path's launches at that shape).  A
   flipped cell of the ProtoGalaxy accumulator's
   witness must make verify() report it; then one more next under
   torch.profiler (device events, busy share, from the raw events) and a
   clean verify().  Checkpoint and resume on this path: the IVC written to
   a temporary directory (`CyclefoldIVC.checkpoint`, the JAX package's file
   format) and resumed into a fresh object from disk (`CyclefoldIVC.resume`),
   a copy with a foreign pp digest refused, then one next on each: their
   `golden.cyclefold_digests` must be equal and verify() of the resumed
   IVC []; the write and read seconds and the file's bytes.
8. B2 at the primary trace's 917,504-point W commit: the bucket sort equal
   to bucket_plan_plain and the accumulate bit-exact, both timed beside
   their twins and bounds.  S1, the rolled-product reduce (on no path): on
   that commit's level-0 partials it must equal B3 msm_reduce and its plain
   twin in affine form (msm_reduce equals the twin word for word), both
   timed in turns and, kernels alone, on CUDA events around each launch
   (`kernel_ms`, not the profiler, which on some machines saw no launch
   of these kernels); on the unsplit
   bucket segments it must equal msm_reduce's two levels, and is timed.
9. Sangria IVC, the second IVC construction: the k = 16 run on the mock keys on
   the card (new, one fold_step) must equal the JAX package's digests
   frozen in `util/golden.py`; then its path (launch counts from here):
   `PublicParams(TrivialStepCircuit(1), TrivialStepCircuit(1), 17, 17)` on
   the two keys above, z0 = [0x11] / [0x22], new, two fold_steps, verify()
   == [], seconds of each and the spans per step (the secondary and
   primary proves, each side's synthesis and SPS), both sides' tape sizes,
   the last step's two SFC witnesses against direct synthesis (timed);
   B1's bucket walk
   (the cross terms' msm_many), B2's sort and accumulate (the W commits),
   B3's reduce and combine must have launched on both curves and the
   batched madd not; a flipped cell of the primary accumulator's witness
   must make verify() report a `primary:` error; one more fold_step under
   torch.profiler; the primary relaxed accumulator saved and loaded back
   onto the card (`util/checkpoint.py`: the same `sangria_acc_digest`,
   every W and E word equal, a foreign pp digest refused; seconds, bytes).
   On the first step's cross terms, (5, 2^17) on each
   curve: `madd_buckets` bit-exact against its twin, msm_many equal to
   best_msm and to the step's commits, the walk, msm_many and best_msm on
   the same five vectors timed; B2 at grumpkin's 917,504-point W commit
   against its twin, timed.
10. The lookup path: the K = 5 traces of `tests/test_lookup.py`'s range
   (2-round SPS) and vector-range (3-round) circuits on the card must equal
   the JAX package's digests frozen in `util/golden.py` (words, commitments,
   challenges); then at k = 17 on the bn256 2^20 key (launch counts from
   here, per circuit) the range circuit (a byte table, row % 256 over all
   rows, and 2^17 seeded values: W1 4 x 2^17 scalars) and the fibo-xor
   circuit (a 2^16-row XOR table of 8-bit values, a chain over all 2^17
   rows: W rounds 3, 3 and 2 x 2^17): two SPS (m_count must launch once
   each), is_sat clean, one changed advice value failing the log-derivative
   check, a Sangria fold of the second trace into the relaxed first
   (verify equal to the prover's instance, is_sat clean) and a ProtoGalaxy
   fold with L = 1 (the same), seconds of each and the spans; m_count,
   B1's bucket walk, B2 and B3 must have launched; m_count on the first
   trace's l and t equal to `m_count_plain` and to the trace's m column,
   timed from a CUDA graph and back to back beside its plain version and
   its bound.
11. Lookup step circuits through both IVC drivers.  (a) Cyclefold on
   `XorLookupStepCircuit(key=3)` at k = 18 on the mock keys, z0 = [2]
   (3 W rounds, 3 chained support folds a next): pp, new, next,
   verify() == [], z = [2 ^ 3 ^ 3]; the pp digest and, after new and
   after next, the ProtoGalaxy and support accumulators' and the pending
   trace's digests must equal the JAX package's frozen in `util/golden.py`.
   (b) The production SHA-256 (launch counts from here):
   `SpreadSha256StepCircuit(bn256_fr, half_bits=16, rounds=64)` through
   Cyclefold at k = 18 on the bn256 2^22 key and the support key, z0 =
   [0x0123456789ABCDEF]: public parameters (W rounds 4,194,304, 786,432 and
   524,288; 3 challenges; the SFC tape's sizes and its replay slots' bytes),
   the last next's replayed SFC witness against direct synthesis (timed),
   new, two next (the second under torch.profiler:
   device events, busy share, the eight busiest device operations),
   verify() == [], z after each step equal to the host `step_fn`, seconds,
   peak device memory and spans of each stage; B1's walk, B2's sort and accumulate (by shape),
   B3 and m_count must have launched, the batched madd not; a flipped
   advice cell of the pending trace must make verify() report it; the
   state checkpointed and resumed (equal digests; seconds, bytes).  B2/B3 at
   the pending trace's 4,194,304-scalar advice commit: every stage against
   its twin, the result equal to the trace's commitment, timed (entries
   `*_sha256`); m_count on its (dense, spread) lookup, where nearly every
   row is the (0, 0) sink, against its plain version and timed (entry
   `m_count_sha256`).  (c) Sangria IVC with `RangeCheckStepCircuit` as the
   primary (2 rounds; its first W round of 2,359,296 scalars on the bn256
   2^22 key) and `TrivialStepCircuit(1)` as the secondary (grumpkin 2^20
   key), k = 17, z0 = [7] / [0]: pp, new, two fold_steps, verify() == [],
   z checked, spans and launch counts (B1's walk, B2, B3 and m_count must
   have launched).
12. The entry points (`sirius_tpu_torch/examples/`): the Merkle-update
   example's `run` at the reference's size (`BASELINE.md:18-20`: depth 32,
   Cyclefold, k = 17) at batch 1 and batch 5 on the bn256 2^22 key (the
   SFC's W round, 14 columns x 2^17, outgrows a 2^20 key) and the support
   key: pp, new, one next, verify() == [], z the host tree's root, seconds,
   peak device memory, spans, the SFC tape's sizes and the next's replayed
   witness (the stateful step's dynamic witness among the tape's inputs)
   against direct synthesis; B1's walk, B2 and B3 must have launched on
   each batch's path (launch counts from each batch's start), the batched
   madd not.  Then the CLI as a user runs it, a process of its own:
   `python3 -m sirius_tpu_torch.examples.cli sangria-instances --fold-steps
   1` (a step circuit with its own public instance column, on its own
   labelled keys) must exit 0 and end with OK.
   Then every MSM, madd and NTT kernel's registers, local (spill) bytes per
   thread, shared bytes and SASS instruction count, the SASS of mul_rows on
   each product (IMAD-class by opcode, IMAD.WIDE and IADD3 counts) and of
   S3's chains by opcode (`cuobjdump`, where the toolkit has it).
13. The mesh phase (run after phase 11, before phase 12, on its keys):
   (a) always, a virtual mesh of 4 shards on cuda:0: sharded commits
   (`commit_device` under `mesh_context`) of 917,504 scalars on the bn256
   2^20 key and 4,194,304 on the 2^22 key equal best_msm's point;
   `NTT.fft_sharded` at 2^20 equals `fft` word for word, forward and
   inverse; the trivial Cyclefold (k = 17, real keys) runs new, two next
   and verify() == [] inside `mesh_context` with the digests 9f3739df /
   13a63ce4, every bucket plan at a shard's size, its W rounds, E and the
   support trace asserted row blocks (`parallel/rows.py`: the sharded
   route, not the whole-round fallback), the sweeps block by block; next's
   seconds and spans beside the main path's next without a mesh (the
   phase's own baseline under `--mesh-only`), the per-block sweeps by
   device and the peak device memory by card (`--mesh-only` also traces a
   third next: its device kernel events by card); phase 9's Sangria IVC
   (k = 16, mock keys) under the mesh with its frozen digests, and the
   JAX package's dry-run folds (`DRYRUN_MC_FOLDS`, m_count on the first
   card); the seconds of each beside one card's (best_msm, fft); then the mesh path's kernels at its
   shapes against their plain twins (B2's sort and accumulate and B3's
   first reduce level on a 229,376-scalar shard, B3's combine over the 4
   shards' buckets in one launch, B4 at a device's (1024, 256) columns,
   the mid twiddle's mul_rows at 262,144 rows), timed beside their bounds,
   and their launches on the mesh path by device.  (b) On a host with two
   or more cards, the same checks on a mesh of every card (the NTT on the
   largest power-of-two count), their seconds beside (a)'s and one card's,
   B2, B3 and the W conversion's mul_rows launched on every card, and one
   SHA-256 Cyclefold next (k = 18) under that mesh with its peak device
   memory by card.  Every line names its mesh.
   `python3 chip_smoke.py --mesh-only` runs this phase alone, after the
   keys it needs and the Cyclefold public parameters.
14. The ring ops' kernels: `addsub_rows` (add and sub) and `mul_rows` at
   K = 1, nb = n on each of the port's five products, at the main path's
   shapes (FIELD_OP_ROWS: the support W's 2^17, the trivial primary W's
   917,504 and the SHA-256 advice round's 4,194,304 rows) against their
   plain twins word for word, each timed from a CUDA graph beside its bound
   (three canonical elements an element at HBM bandwidth; int64 words move
   twice that) and its twin; then, for each configuration of the benchmark
   (port_bench/configs/: its step circuit, k, keys and a z_0 from SEED),
   pp, new, one next, and one more next under torch.profiler: its kernel
   events (the benchmark's `launches_per_step` counts the same: not Memcpy
   or Memset) beside the ring ops in it by broadcast form (`ring_form`) and
   their launches (`ring_op.launches`, and `_build.device_launches` by entry
   and card, the ring ops under "ring_op"), one a ring op.
   `python3 chip_smoke.py --field-ops` runs this phase alone, after the
   benchmark's keys (loaded from the key cache where `SIRIUS_TPU_CACHE`
   holds them, the benchmark's `port_bench/.cache/keys` after a benchmark
   run, and derived into it otherwise).

Ends with a JSON line of kernel results (time, plain twin's time, bound
and what sets it, launches on the path that runs the kernel: B1's bucket
walk, B2 and B3 on the Cyclefold IVC path, B4, its epilogue pass (an entry of its
own) and the K = 1 product on the NTT path (its W conversion on the IVC
path: `mul_rows_to_mont`); the walk on each curve and B2 at
grumpkin's W commit (entries of their own) on the Sangria path;
`m_count` (the scalar lookup's l and t, timed from a CUDA graph) and
`m_count_vector` (the vector lookup's) on the lookup path, which replace no
Pallas kernel (`replaces` names the JAX package's jitted sort);
`bucket_sort_sha256`, `msm_accumulate_sha256`, `msm_reduce_sha256`,
`msm_combine_sha256` and `m_count_sha256` at the SHA-256 path's largest W
commit and lookup, with the launches of that shape (the reduce's and
m_count's: all of the path's);
`bucket_sort_mesh`, `msm_accumulate_mesh`, `msm_reduce_mesh`,
`msm_combine_mesh`, `col_ntt_mesh` and `mul_rows_mesh` at the mesh path's
shapes, with its launches in all and by device (`launches_by_device`;
`launches_every_card` on a multi-card host) and the mesh (`mesh`);
the probes S1-S4 and B1's batched madd run on no path but their own timed
runs, which are counted, a CUDA graph's replays included (S1's time is its
wrapper's on CUDA events, as every entry's but S2's, S3's, S4's and the
batched madd's: theirs, and S3's and S4's library calls', are the device
time per launch from a CUDA graph); S2's kernel `mul_rows` has a second
entry at the NTT path's K = 1 shape (the coset powers), a third on the
carry-chain product and a fourth on the wide one; B2's sort and
accumulate have one at the support W commit (the launches of every other
size; grumpkin for the accumulate) and one at the primary (917,504 points;
bn256); B3's combine has one at best_msm's shape (t = 1) and one at
msm_many's (t > 1), each with the launches of its own shapes, and its
window-sum kernel an entry of its own), the nvidia-smi
line, and the device JSON line.  Bounds: the larger of the
canonical bytes moved (32 B per field element, each input read once and
each output written once) over 3.35 TB/s and the Montgomery products the
function needs (none for a twiddle of 1 or an add onto the identity that
seeds an accumulator) times FE_MUL_IMADS integer multiply-adds over 64 per
clock per SM x the SMs x the SM clock nvidia-smi reads.  Fails (non-zero
exit, no result) without CUDA or on any failed check.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from sirius_tpu_torch.curves.hash_to_curve import hash_bytes_to_point
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.examples import merkle_tree
from sirius_tpu_torch.examples._drive import span_totals as span_seconds
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr, bn256_g1
from sirius_tpu_torch.fields.jfield import FQ, FR, ints_to_words
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.gadgets.range_step_circuit import RangeCheckStepCircuit
from sirius_tpu_torch.gadgets.sha256_step_circuit import step_fn as sha256_step_fn
from sirius_tpu_torch.gadgets.spread_sha256 import SpreadSha256StepCircuit
from sirius_tpu_torch.gadgets.xor_lookup_step_circuit import XorLookupStepCircuit
from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams, _cf_flatten
from sirius_tpu_torch.ivc.sangria_ivc import IVC as SangriaIVC
from sirius_tpu_torch.ivc.sangria_ivc import PublicParams as SangriaPublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.ivc.support_fold import SupportFoldChain, random_input, support_structure
from sirius_tpu_torch.nifs.protogalaxy import AccumulatorInstance, ProtoGalaxy
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from sirius_tpu_torch.ops import _build, field_kernels as fk, madd as madd_mod, microbench as mb, msm_kernels as mk
from sirius_tpu_torch.ops import lookup_kernels, ntt_kernels
from sirius_tpu_torch.ops.commitment import DEVICE_SETUP_CHUNK, CommitmentKey
from sirius_tpu_torch.ops.msm import FAN_IN, MANY_GROUPS, MANY_WINDOW_BITS, best_msm, bucket_plan, bucket_plan_plain
from sirius_tpu_torch.ops.msm import msm_sharded, signed_window_bits
from sirius_tpu_torch.ops.msm import msm_many
from sirius_tpu_torch.ops.msm import reduce_segments, split_segments
from sirius_tpu_torch.ops.ntt import NTT
from sirius_tpu_torch.ops.ntt_kernels import col_ntt, col_ntt_plain
from sirius_tpu_torch.parallel import Mesh, RowBlocks, gather_rows, make_mesh, mesh_context, shard_rows
from sirius_tpu_torch.parallel import rows as rows_mod
from sirius_tpu_torch.parallel.rows import gathered
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.plonk import satisfy
from sirius_tpu_torch.ops.lookup_kernels import m_count_plain
from sirius_tpu_torch.plonk.sps import run_sps_protocol
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.checkpoint import load_sangria_accumulator, save_sangria_accumulator
from sirius_tpu_torch.util.golden import pg_acc_digest, sangria_acc_digest
from sirius_tpu_torch.util.interop import limbs_to_words
from sirius_tpu_torch.util.profiling import profiler
from sirius_tpu_torch.util.testing import (FiboXorLookupCircuit, MockCommitmentKey, RangeCircuit, VectorRangeCircuit,
                                           dryrun_sangria_folds, reference_msm)

from msm_turns import gpu_ms, graph_ms, kernel_ms

DEVICE = "cuda:0"
SEED = 20261016
FOLDS = 2
IVC_K = 17  # bench.py's cyclefold_trivial_k17
IVC_Z0 = [0x42]
IVC_STEPS = 2
B1_PAIRS = 1 << 16
MSM_CHECK_LOG = 12
PRIMARY_LOG = 20
SUPPORT_KEY_LOG = 17  # the support key: the first 2^17 points of the grumpkin key
GRUMPKIN_KEY_LOG = 20  # the grumpkin key b"bench-support" (SHAKE-256 over the label: its prefix is the support key)
CROSS_TERMS = 5  # gate degree of the support circuit
CROSS_N = 1 << 14  # cross-term length (rows)
W_COMMIT_N = 7 << 14  # support W commit length (7 advice columns x 2^14 rows)
NTT_LOG = 20  # bench.py's ntt_elems_per_sec_2^20
MID_REP = 4  # mul_rows K = 1 with each row of b repeated: the nested route's broadcast mid twiddle
S2_N, S2_K = 1 << 17, 8  # scripts/tpu_microbench.py: (1024, 128) elements, K = 8
S2_ENTRIES = {"unrolled": "mul_chain", "cc": "mul_chain_cc", "wide": "mul_chain_wide"}  # product: kernels-line name
S3_N, S3_REPS = 1 << 22, 64  # 2^22 values: the TPU's (512, 128) would not fill 132 SMs
LONG_K, LONG_REPS = 256, 4096  # chains long enough that the rate, not the memory traffic, sets the time
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
IMADS_PER_CLK_SM = 64  # 32-bit integer multiply-adds per clock per SM, compute capability 9.0
FE_MUL_IMADS = 136  # csrc/field.cuh:141-177: 8 rounds x (8 + 1 + 8) 32x32-bit products
FE = 32  # bytes of one canonical field element
ROOT = Path(__file__).resolve().parent
STARTED = time.perf_counter()
# reference src/fft.rs:241-252: fft([0..8]) over bn256 Fr
GOLDEN_FFT8 = [
    28,
    68918385373930674424918168212551896122229959265833979749191472831399925654,
    17631683881184975370165255887551781615748388533673675138856,
    68918385373930639161550405842601155791718184162270748252414405484049647934,
    21888242871839275222246405745257275088548364400416034343698204186575808495613,
    21819324486465344583084855339414673932756646216253763595445789781091758847675,
    21888242871839275204614721864072299718383108512864252727949815652902133356753,
    21819324486465344547821487577044723192426134441150200363949012713744408569955,
]
MADD_MULS, ADD_MULS, DBL_MULS = 11, 16, 7  # Montgomery products: csrc/curve.cuh pt_madd, pt_add_ilp, pt_dbl_ilp
ADD_LEVELS, DBL_LEVELS = 5, 3  # dependent product levels of csrc/curve.cuh pt_add_ilp, pt_dbl_ilp
LATENCY_K = 1024  # the latency probe's chain of dependent products on one element
MANY_SHAPE = (CROSS_TERMS, 64, 15, 4)  # msm_many's combine: (t, W, B, c) at 4-bit windows
PRIMARY_W_N = 7 << 17  # the primary trace's W commit (7 advice columns x 2^17 rows)
PLAN_ARRAYS = ("entries", "chunk_start", "chunk_len", "seg_off")  # B2's bucket sort output
B2_NAMES = ("msm_accumulate", "msm_accumulate_primary", "bucket_sort", "bucket_sort_primary",
            "msm_accumulate_sangria_grumpkin")
CYCLEFOLD_DIGESTS = ("9f3739df", "13a63ce4")  # pg_acc_digest, sangria_acc_digest after 2 next, as every run had them
SANGRIA_K = 17  # BASELINE.md:23, benches/sangria_poseidon.rs:29-31: the reference bench's table size
SANGRIA_GOLDEN_K = 16  # the JAX package's run frozen in util/golden.py
SANGRIA_Z0 = ([0x11], [0x22])  # examples/sangria_trivial.py:49-52
SANGRIA_STEPS = 2
SANGRIA_CROSS = (CROSS_TERMS, 1 << SANGRIA_K)  # msm_many on a step's cross terms: (t, n), both curves
LOOKUP_GOLDEN_K, LOOKUP_GOLDEN_KEY_LOG = 5, 9  # tests/test_lookup.py's K and key, frozen in util/golden.py
LOOKUP_K = 17  # the lookup phase's traces, on the bn256 2^20 key
LOOKUP_TABLE = 256  # sirius_tpu/gadgets/range_step_circuit.py:19: the range check's byte table
LOOKUP_XOR_BITS = 8  # the fibo-xor circuit's table: 2^16 rows of (x, y, x ^ y)
PRIMARY_KEY_LOG = 22  # the bn256 key b"bench-primary": the SHA-256 primary's first W round (4,194,304) fits
XOR_LOOKUP_K, XOR_LOOKUP_Z0 = 18, [2]  # tests/test_cyclefold.py::test_cyclefold_lookup_step, frozen in util/golden.py
SHA_K, SHA_HALF_BITS, SHA_ROUNDS = 18, 16, 64  # README.md:78: the table16-class step's production configuration
SHA_Z0 = [0x0123456789ABCDEF]  # examples/sha256_table16.py
SHA_STEPS = 2
SHA_ROUND_SIZES = [16 << SHA_K, 3 << SHA_K, 2 << SHA_K]  # advice, (l, t, m) of the 2-column lookup, (h, g)
RANGE_K, RANGE_Z0 = 17, ([7], [0])  # tests/test_sangria_ivc.py::test_sangria_ivc_lookup_step
RANGE_STEPS = 2
MERKLE_BATCHES = (1, 5)  # BASELINE.md:18-20: the reference's Merkle-update rows, batch 1..5, depth 32, Cyclefold
CLI_ARGV = ["sangria-instances", "--fold-steps", "1"]  # examples/instances.py: its own 2^19 keys, k = 16
MESH_SHARDS = 4  # the virtual mesh: four shards on cuda:0, the counterpart of the JAX tests' virtual devices
MESH_COMMITS = (PRIMARY_W_N, SHA_ROUND_SIZES[0])  # the primary W (2^20 key) and the SHA-256 path's largest W round
FIELD_OP_ROWS = (1 << 17, 7 << 17, 1 << 22)  # the support W, the trivial primary W, the SHA-256 advice round
FIELD_OP_BYTES = 3 * FE  # a ring op's element: a, b and out, 32 canonical bytes each (int64 words move twice that)
MESH_ENTRIES = {"bucket_sort_mesh": "msm_bucket_scatter", "msm_accumulate_mesh": "msm_accumulate",
                "msm_reduce_mesh": "msm_reduce", "msm_combine_mesh": "msm_horner", "col_ntt_mesh": "col_ntt",
                "mul_rows_mesh": "mul_rows"}  # kernels-line entry: the C entry its launches are counted by


def lookup_ro() -> PoseidonHash:
    """The SPS and Sangria transcripts of the lookup phase (tests/test_lookup.py's)."""
    return PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))


def pg_ro() -> PoseidonHash:
    """ProtoGalaxy's transcript over the scalar field (tests/test_protogalaxy.py's)."""
    return PoseidonHash(poseidon_spec(bn256_fr, 3, 2, 4, 3))


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - STARTED:7.1f} s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound(muls: float, nbytes: float, imad_rate: float, per_mul: int = FE_MUL_IMADS) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of muls * per_mul
    integer multiply-adds at the card's rate and nbytes at HBM bandwidth."""
    ops_ms = muls * per_mul / imad_rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def word_err(a, b) -> float:
    """Largest absolute difference between two batches of word tensors
    (bit-exact: 0)."""
    return float(max(int((x - y).abs().max()) if x.numel() else 0 for x, y in zip(a, b)))


def point_err(curve, P, Q) -> float:
    """0 when the Jacobian batches P and Q hold the same points (affine
    equality, on the device): the identity flags must agree, and x1 z2^2,
    y1 z2^3 must equal x2 z1^2, y2 z1^3; otherwise the largest word
    difference of those products (at least 1)."""
    f = curve.fb
    z1s, z2s = f.square(P.z), f.square(Q.z)
    lhs = torch.stack([f.mul(P.x, z2s), f.mul(P.y, f.mul(z2s, Q.z))])
    rhs = torch.stack([f.mul(Q.x, z1s), f.mul(Q.y, f.mul(z1s, P.z))])
    flags = bool((f.is_zero(P.z) != f.is_zero(Q.z)).any())
    return max(word_err([lhs], [rhs]), float(flags))


def seeded_adds(lengths) -> int:
    """Curve adds an accumulator seeded with the identity needs over runs
    of these lengths: L - 1 for a run of L points (the first is a copy)."""
    return int((lengths - 1).clamp(min=0).sum())


def log2_ceil(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 0


def combine_chains(W: int, B: int, c: int) -> dict[str, tuple[int, int]]:
    """(adds, doublings) on the longest dependent chain of B3's kernels
    (csrc/msm.cu) for buckets of W windows of B: the window sums (a segment
    walk of 2L complete adds, a suffix scan and a tree of log2 S adds each,
    an add and log2 L doublings) and, with the grouped Horner (c (W - 1)
    doublings, (K - 1) + (G - 1) adds), the combine."""
    log2L = mk.window_log2(B)
    S = -(-B // (1 << log2L))
    K = mk.horner_group_size(W)
    G = -(-W // K)
    window = (2 * (1 << log2L) + 2 * log2_ceil(S) + 1, log2L)
    return {"msm_window_sums": window, "msm_combine": (window[0] + (K - 1) + (G - 1), window[1] + c * (W - 1))}


def combine_stage(curve, shaped, c, timed: bool) -> dict:
    """B3's window sums and combine on (t, W, B) buckets against their twins
    (affine form); {kernel: [max_abs_err, ms, plain_ms, Montgomery products,
    canonical bytes]}, timed only when `timed`."""
    t, W, B = shaped.x.shape[:3]
    flat = lambda P: Points(*(a.reshape(-1, 8) for a in P))  # noqa: E731
    L = 1 << mk.window_log2(B)
    tot = mk.msm_window_sums(curve, shaped)
    err_w = point_err(curve, flat(tot), flat(mk.msm_window_sums_plain(curve, shaped, L)))
    check(err_w == 0, f"B3 msm_window_sums disagrees with its twin at {(t, W, B)}")
    res = mk.msm_combine(curve, shaped, c)
    err = point_err(curve, res, mk.msm_combine_plain(curve, shaped, c))
    check(err == 0, f"B3 msm_combine disagrees with its twin at {(t, W, B)}")
    sums = ADD_MULS * 2 * t * W * (B - 1)  # the running sums: 2 (B - 1) adds per window
    return {"msm_window_sums": [err_w, gpu_ms(lambda: mk.msm_window_sums(curve, shaped)) if timed else None,
                                gpu_ms(lambda: mk.msm_window_sums_plain(curve, shaped, L), reps=1) if timed else None,
                                sums, 3 * FE * t * W * B + 3 * FE * t * W],
            "msm_combine": [err, gpu_ms(lambda: mk.msm_combine(curve, shaped, c)) if timed else None,
                            gpu_ms(lambda: mk.msm_combine_plain(curve, shaped, c), reps=1) if timed else None,
                            sums + t * (W - 1) * (DBL_MULS * c + ADD_MULS), 3 * FE * t * W * B + 3 * FE * t]}, res


def sort_bytes(plan, n: int) -> int:
    """Canonical bytes of B2's bucket sort of n scalars: the scalars read;
    32-bit entries, chunk starts and lengths, and segment offsets written."""
    return FE * n + 4 * plan.entries.shape[0] + 8 * plan.chunk_start.shape[0] + 4 * plan.seg_off.shape[0]


def msm_stages(curve, S, pts, timed: bool = False, combine: bool = True):
    """best_msm's stages at the shapes it gives them: B2's bucket sort
    (bit-exact against bucket_plan_plain), B2 accumulate, every
    B3 reduce level, B3 window sums and combine.  Each kernel is held
    against its plain twin on the same inputs, and the kernel's output feeds
    the next stage.  Returns (the (1, 8) Jacobian result, {kernel:
    [max_abs_err, ms, plain_ms, Montgomery products, canonical bytes]}, the
    plan); times only when `timed` (the reduce time and work are its first
    level's).  Without `combine` it stops at the (1, W, B) buckets and
    returns them in the result's place."""
    plan = bucket_plan(S)
    plain_plan = bucket_plan_plain(S)
    check((plan.c, plan.W, plan.B) == (plain_plan.c, plain_plan.W, plain_plan.B)
          and all(torch.equal(getattr(plan, k), getattr(plain_plan, k)) for k in PLAN_ARRAYS),
          f"B2's bucket sort differs from bucket_plan_plain at {S.shape[0]} points")
    out = {"bucket_sort": [0, gpu_ms(lambda: bucket_plan(S)) if timed else None,
                           gpu_ms(lambda: bucket_plan_plain(S), reps=1) if timed else None, 0,
                           sort_bytes(plan, S.shape[0])]}
    acc = (curve, plan.entries, plan.chunk_start, plan.chunk_len, pts.x.contiguous(), pts.y.contiguous())
    parts = mk.msm_accumulate(*acc)
    err = word_err(parts, mk.msm_accumulate_plain(*acc))
    check(err == 0, f"B2 msm_accumulate is not bit-exact against its twin at {S.shape[0]} points")
    n_entries, n_chunks = plan.entries.shape[0], plan.chunk_start.shape[0]
    out["msm_accumulate"] = [err, gpu_ms(lambda: mk.msm_accumulate(*acc)) if timed else None,
                             gpu_ms(lambda: mk.msm_accumulate_plain(*acc), reps=1) if timed else None,
                             MADD_MULS * seeded_adds(plan.chunk_len),
                             4 * n_entries + 8 * n_chunks + 2 * FE * pts.x.shape[0] + 3 * FE * n_chunks]

    seg_off, level, red_err = plan.seg_off, 0, 0.0
    while True:
        deep = int((seg_off[1:] - seg_off[:-1]).max()) > FAN_IN
        sub_off, nxt = split_segments(seg_off, FAN_IN) if deep else (seg_off, None)
        red = mk.msm_reduce(curve, sub_off, parts)
        err = word_err(red, mk.msm_reduce_plain(curve, sub_off, parts))
        check(err == 0, f"B3 msm_reduce level {level} is not bit-exact against its twin at {S.shape[0]} points")
        red_err = max(red_err, err)
        if level == 0:
            args = (curve, sub_off, parts)
            n_parts, n_seg = parts.x.shape[0], sub_off.shape[0] - 1
            out["msm_reduce"] = [None, gpu_ms(lambda: mk.msm_reduce(*args)) if timed else None,
                                 gpu_ms(lambda: mk.msm_reduce_plain(*args), reps=1) if timed else None,
                                 ADD_MULS * seeded_adds(sub_off[1:] - sub_off[:-1]),
                                 3 * FE * n_parts + 4 * (n_seg + 1) + 3 * FE * n_seg]
        parts, level = red, level + 1
        if nxt is None:
            break
        seg_off = nxt
    out["msm_reduce"][0] = red_err

    shaped = Points(*(b.reshape(1, plan.W, plan.B, 8) for b in parts))
    if not combine:
        return shaped, out, plan
    comb, res = combine_stage(curve, shaped, plan.c, timed)
    out.update(comb)
    return res, out, plan


def profiled(label: str, fn) -> str:
    """One traced call of fn: device launches, device busy seconds (sum of
    the device-side events; one stream, so they do not overlap) and its
    share of the call's wall time (closed by a synchronize).  fn may return
    a dict of phase seconds to print.  Reads the profiler's raw events: its
    parsed event tree (`prof.events()`) takes minutes to build over the
    ~650,000 events of a k = 18 step, and gave the same device events and
    busy share on the trivial next."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        secs = fn() or {}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in dev) / 1e9
    top = {}
    for e in dev:
        top[e.name()] = top.get(e.name(), 0.0) + e.duration_ns() / 1e6
    lines = [f"{label} (profiler on): wall {wall:.4f} s ("
             + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items())
             + f"), {len(dev)} device events, device busy {busy:.4f} s = {100 * busy / wall:.1f}% of wall"]
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        lines.append(f"  {ms:9.3f} ms  {name[:90]}")
    return "\n".join(lines)


def cf_digests(ivc) -> tuple[str, str, str]:
    """`golden.cyclefold_digests` of a Cyclefold IVC: its ProtoGalaxy and
    support accumulators and its pending trace, every W round's words."""
    return golden.cyclefold_digests(ivc, [gathered(w).cpu().numpy() for w in ivc.primary_trace.w.W])


def ckpt_bytes(path: str) -> int:
    """Bytes of a checkpoint (`path`.json and `path`.npz)."""
    return sum(Path(path + ext).stat().st_size for ext in (".json", ".npz"))


def sass_opcodes() -> dict[str, Counter] | None:
    """SASS instructions by opcode per kernel of the built library
    (cuobjdump), by mangled name; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    dump = subprocess.run([tool, "-sass", _build.library()._name], capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = Counter()
        elif cur:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[cur][m.group(1)] += 1
    return counts


def synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


@contextmanager
def last_calls(cls, name: str, keep: int = 1):
    """While the block runs, keep the arguments and result of the last
    `keep` calls of the method (or static method) `cls.name`."""
    raw = cls.__dict__[name]
    static = isinstance(raw, staticmethod)
    fn = raw.__func__ if static else raw
    calls = []

    def wrapper(*args):
        out = fn(*args)
        calls.append((args, out))
        del calls[:-keep]
        return out

    setattr(cls, name, staticmethod(wrapper) if static else wrapper)
    try:
        yield calls
    finally:
        setattr(cls, name, raw)


def tape_sizes(taped) -> str:
    s = taped.sizes()
    return f"{s['ops']} ops, {s['inputs']} inputs, {s['consts']} constants, {s['out_slots']} output slots"


def same_words(W, direct) -> bool:
    """A replayed witness ((n, 8) u32 words a column) against direct
    synthesis's int columns, word for word."""
    return len(W) == len(direct) and all(np.array_equal(c, ints_to_words(d).astype(np.uint32))
                                         for c, d in zip(W.cols, direct))


def cf_replay_check(label: str, call, card: str) -> None:
    """Replay against direct synthesis on the SFC inputs of one Cyclefold
    step (a recorded `CyclefoldIVC._sfc_witness` call): the recorded
    witness, a second replay and the direct synthesis must be equal word for
    word.  A stateful step circuit's dynamic witness is still the step's."""
    (ivc, inputs, _), (W, _, x1) = call
    pp = ivc.pp
    t0 = time.perf_counter()
    again, _ = pp.sfc_taped.replay(_cf_flatten(inputs, pp.sc))
    t1 = time.perf_counter()
    direct = ivc._sfc_witness_direct(inputs, inputs.self_incoming.instances[0][1], x1)
    t2 = time.perf_counter()
    check(same_words(W, direct) and same_words(again, direct),
          f"{label}: the replayed SFC witness differs from direct synthesis")
    log(f"{label}: the step's SFC witness by native replay {t1 - t0:.4f} s, by direct synthesis {t2 - t1:.4f} s: "
        f"equal word for word ({len(W)} columns x {W.cols[0].shape[0]} rows)  [{card}]")


def sg_replay_check(label: str, calls, card: str) -> None:
    """The same for a Sangria step: both sides' recorded `IVC._witness`
    calls."""
    for (side, sfc, fspec, x1), W in calls:
        t0 = time.perf_counter()
        again = SangriaIVC._witness(side, sfc, fspec, x1)
        t1 = time.perf_counter()
        x0 = sfc.inp.u.instances[0][1] % fspec.modulus  # the incoming instance's X1, this trace's X0
        direct = SangriaIVC._witness_direct(side, sfc, fspec, sfc.instances([x0, x1]), x1)
        t2 = time.perf_counter()
        check(same_words(W, direct) and same_words(again, direct),
              f"{label} ({fspec.name} SFC): the replayed witness differs from direct synthesis")
        log(f"{label} ({fspec.name} SFC): native replay {t1 - t0:.4f} s, direct synthesis {t2 - t1:.4f} s: equal "
            f"word for word ({len(W)} columns x {W.cols[0].shape[0]} rows)  [{card}]")


def synced_all() -> float:
    """The host clock once every visible card has finished its queued work."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return time.perf_counter()


def canonical_words(rng, n: int, dev) -> torch.Tensor:
    """(n, 8) words of 252-bit values: canonical bn256 Fr elements, which
    read as Montgomery or as standard form alike."""
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
    w[:, 7] &= 0x0FFFFFFF
    return torch.from_numpy(w).to(dev)


class MeshLaunches:
    """Runs calls of the mesh path and keeps the kernel launches they made,
    by (C entry, device) (`_build.device_launches`); the comparisons run
    outside it and are not counted."""

    def __init__(self):
        self.counts = Counter()

    def __call__(self, fn):
        before = Counter(_build.device_launches)
        out = fn()
        self.counts.update(Counter(_build.device_launches) - before)
        return out

    def by_device(self, entry: str) -> dict[str, int]:
        return {d: k for (e, d), k in sorted(self.counts.items()) if e == entry}


def mesh_checks(mesh, keys, pp, rng, card: str, base: dict, trace: bool) -> tuple[dict, MeshLaunches]:
    """The mesh phase's checks on `mesh`, each line naming it: the sharded
    commits of MESH_COMMITS scalars (`commit_device` under `mesh_context`;
    W made on the key's card) equal best_msm's point on one card; the 2^20
    NTT by `fft_sharded` equals `fft` word for word, both directions; the
    trivial Cyclefold (k = 17, the real keys) under `mesh_context`: new, two
    next and verify() == [], its digests CYCLEFOLD_DIGESTS, every commit of
    both curves through the key's shards, W, E and the support trace as row
    blocks, the sweeps block by block on every device, next's seconds and
    spans beside `base` (the same run without a mesh), the peak device memory
    by card and (`trace`) a traced third next's device events by card;
    then phase 9's
    Sangria IVC (k = 16) and the dry-run folds under the mesh.  Returns the
    seconds ({what: (on the mesh, warm on the mesh, on one card)}) and the
    mesh path's launches."""
    ck1_full, ck1, ck2 = keys
    name, run, secs = mesh.describe(), MeshLaunches(), {}
    for ck, n in ((ck1, MESH_COMMITS[0]), (ck1_full, MESH_COMMITS[1])):
        W = canonical_words(rng, n, ck.device)
        one_card = lambda: best_msm(BN256_G1, FR.from_mont(W), Points(*(c[:n] for c in ck.points)))  # noqa: E731
        want = one_card()
        t0 = synced_all()
        one_card()  # warm, as the mesh's second call
        t1 = synced_all()
        with mesh_context(mesh):
            got = run(lambda: ck.commit_device(W))
            t2 = synced_all()
            again = run(lambda: ck.commit_device(W))
            t3 = synced_all()
        check(got == again == want, f"the sharded commit of {n} scalars on {name} differs from best_msm")
        check((mesh, n) in ck.shard_cache, f"the commit of {n} scalars on {name} did not use the key's shards")
        secs[f"commit {n}"] = (t2 - t1, t3 - t2, t1 - t0)
        # the MSM alone (standard words given): across the mesh stage by stage, the same shards' pipelines one
        # after another (each shard's best_msm on its card, in turns), and best_msm on one card
        S, shards = FR.from_mont(W), ck.shards(mesh, n)
        t4 = synced_all()
        run(lambda: msm_sharded(BN256_G1, S, shards, mesh))
        t5 = synced_all()
        for Sd, Pd in zip(shard_rows(mesh, S), shards):
            best_msm(BN256_G1, Sd, Pd)
            synced_all()
        t6 = synced_all()
        best_msm(BN256_G1, S, Points(*(c[:n] for c in ck.points)))
        t7 = synced_all()
        secs[f"msm {n}"] = (t5 - t4, t6 - t5, t7 - t6)
        log(f"sharded commit of {n} bn256 scalars (the 2^{ck.k} key) on {name}: equals best_msm on one card; first "
            f"{t2 - t1:.4f} s (places the key's shards), warm {t3 - t2:.4f} s; best_msm on {ck.device} warm "
            f"{t1 - t0:.4f} s (each with W's from_mont); the MSM alone: msm_sharded {t5 - t4:.4f} s, the "
            f"{mesh.size} shards' best_msm one after another {t6 - t5:.4f} s, best_msm on one card {t7 - t6:.4f} s"
            f"  [{card}]")
    ctx = NTT(FR, NTT_LOG, ck1.device)
    D = mesh.size
    ntt_mesh = mesh if ctx.n2 % D == 0 else Mesh(mesh.devices[: 1 << (D.bit_length() - 1)])  # a power of two
    a = canonical_words(rng, 1 << NTT_LOG, ctx.device)
    blocks = shard_rows(ntt_mesh, a)
    for inverse in (False, True):
        got = gather_rows(ntt_mesh, run(lambda: ctx.fft_sharded(blocks, ntt_mesh, inverse)))
        check(torch.equal(got, ctx.fft(a, inverse)), f"fft_sharded (inverse={inverse}) on {ntt_mesh.describe()} "
              f"differs from fft at k = {NTT_LOG}")
    reps = 5
    t0 = synced_all()
    for _ in range(reps):
        run(lambda: ctx.fft_sharded(blocks, ntt_mesh, False))
    t1 = synced_all()
    for _ in range(reps):
        ctx.fft(a)
    t2 = synced_all()
    secs["fft"] = ((t1 - t0) / reps, (t1 - t0) / reps, (t2 - t1) / reps)
    log(f"fft_sharded 2^{NTT_LOG} bn256 Fr on {ntt_mesh.describe()}: equals fft word for word, forward and inverse; "
        f"warm forward {(t1 - t0) / reps:.6f} s (mean of {reps}), fft on {ctx.device} {(t2 - t1) / reps:.6f} s  "
        f"[{card}]")
    plans = dict(bucket_plan.shapes)
    sweeps_before = Counter(rows_mod.sweeps)
    reset_peaks()
    with mesh_context(mesh):
        t0 = synced_all()
        ivc = run(lambda: CyclefoldIVC(pp, IVC_Z0))
        t1 = synced_all()
        span_seconds()
        steps, spans = [], []
        for _ in range(IVC_STEPS):
            run(ivc.next)
            steps.append(synced_all())
            spans.append(span_seconds())
        digests = cf_digests(ivc)[:2]
        check_row_blocks(mesh, [*ivc.primary_trace.w.W, *ivc.self_acc.trace.w.W, *ivc.support_acc.W.W,
                                ivc.support_acc.W.E], f"the Cyclefold IVC's W rounds and E on {name}")
        peaks = card_peaks()
        if trace:  # a third next, traced (~40 s with the profiler's processing: `--mesh-only` only)
            events = device_events(lambda: run(ivc.next))
        t2 = synced_all()
        errors = run(ivc.verify)
        t3 = synced_all()
    sweeps = dict(Counter(rows_mod.sweeps) - sweeps_before)
    check(errors == [], f"the Cyclefold IVC on {name}: verify reported {errors}")
    check(all(d.startswith(w) for d, w in zip(digests, CYCLEFOLD_DIGESTS)),
          f"the Cyclefold digests on {name} moved: {digests}, not {CYCLEFOLD_DIGESTS}...")
    plans = {m: k - plans.get(m, 0) for m, k in bucket_plan.shapes.items() if k > plans.get(m, 0)}
    shard_n = [-(-n // D) for n in (PRIMARY_W_N, W_COMMIT_N)]  # the first (longest) shard of each W commit
    check(all(plans.get(m) for m in shard_n) and max(plans) <= shard_n[0],
          f"the Cyclefold commits on {name} did not all go through the shards: bucket plans by size {plans}")
    check(set(sweeps) == {str(d) for d in mesh.distinct} and sum(sweeps.values()) % D == 0,
          f"the sweeps on {name} did not run block by block on every device: {sweeps}")
    nexts = [b - a for a, b in zip([t1, *steps], steps)]
    secs["next"] = (nexts[0], nexts[-1], base["next"])
    log(f"Cyclefold IVC k={IVC_K} under mesh_context on {name}, W, E and the support trace as row blocks: new "
        f"{t1 - t0:.4f} s, next " + " / ".join(f"{x:.4f}" for x in nexts) + f" s (without a mesh, the same run: "
        + " / ".join(f"{x:.4f}" for x in base["nexts"]) + f" s), verify() == [] in {t3 - t2:.4f} s; digests "
        f"{digests[0][:8]} / {digests[1][:8]} (as without a mesh); bucket plans by size {plans}  [{card}]")
    for i, (sp, bp) in enumerate(zip(spans, base["spans"])):
        log(f"  next {i + 1} spans on {name}: " + ", ".join(f"{k} {v:.4f} s" for k, v in sp.items())
            + "; without a mesh: " + ", ".join(f"{k} {v:.4f} s" for k, v in bp.items()))
    log(f"  per-block sweeps by device over new, {IVC_STEPS + trace} next and verify on {name}: {sweeps}; "
        + (f"the traced third next: {events}; " if trace else "") + f"peak device memory by card over new and {IVC_STEPS} next: {peaks} (without a mesh "
        f"{base['peaks']})  [{card}]")
    secs["sangria k16"] = mesh_sangria(mesh, run, card)
    secs["dry-run folds"] = mesh_dryrun(mesh, run, card)
    log(f"launches on the mesh path on {name} by (C entry, device): {dict(sorted(run.counts.items()))}")
    return secs, run


def check_row_blocks(mesh, rounds, what: str) -> None:
    """Every round is row blocks (`parallel/rows.py`) of `mesh`, block d on
    its device d: the sharded route, never the whole-round fallback."""
    for w in rounds:
        check(isinstance(w, RowBlocks) and w.mesh == mesh and w.devices == list(mesh.devices),
              f"{what}: {w!r} is not row blocks on {mesh.describe()}")


def reset_peaks() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)


def card_peaks() -> dict[str, str]:
    """Peak device memory by card since `reset_peaks`, in GB (the keys' included)."""
    out = {}
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
        out[f"cuda:{i}"] = f"{torch.cuda.max_memory_allocated(i) / 1e9:.3f} GB"
    return out


def device_events(fn) -> str:
    """One traced call of fn: its wall seconds (closed by every card's
    synchronize) and the device kernels it launched by card, with their busy
    seconds (the profiler's raw events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = synced_all() - t0
    by_card, busy = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_card[f"cuda:{e.device_index()}"] += 1
            busy[f"cuda:{e.device_index()}"] += e.duration_ns() / 1e9
    return (f"wall {wall:.4f} s (profiler on), device events by card {dict(by_card)}, busy by card "
            + ", ".join(f"{c} {b:.4f} s = {100 * b / wall:.1f}%" for c, b in busy.items()))


def mesh_sangria(mesh, run, card: str) -> tuple:
    """Phase 9's Sangria IVC (trivial step both sides, k = 16, the mock keys
    on cuda:0) under `mesh`: both accumulators' digests after new and one
    fold_step equal the JAX package's frozen ones, verify() == [], both
    sides' W rounds and E row blocks.  Returns (new + fold_step s, fold_step
    s, None)."""
    dev = torch.device(DEVICE)
    mpp = SangriaPublicParams(TrivialStepCircuit(arity=1), TrivialStepCircuit(arity=1), SANGRIA_GOLDEN_K,
                              SANGRIA_GOLDEN_K, MockCommitmentKey(BN256_G1, dev), MockCommitmentKey(GRUMPKIN, dev))
    accs = lambda v: (sangria_acc_digest(v.primary_relaxed.U), sangria_acc_digest(v.secondary_relaxed.U))  # noqa: E731
    with mesh_context(mesh):
        t0 = synced_all()
        mivc = run(lambda: SangriaIVC(mpp, *SANGRIA_Z0))
        got_new = accs(mivc)
        t1 = synced_all()
        run(mivc.fold_step)
        t2 = synced_all()
        errors = run(mivc.verify)
    check(got_new == golden.SANGRIA_IVC_K16_NEW and accs(mivc) == golden.SANGRIA_IVC_K16_STEP and errors == [],
          f"Sangria k = {SANGRIA_GOLDEN_K} on {mesh.describe()}: {got_new} {accs(mivc)} {errors}")
    check_row_blocks(mesh, [w for acc in (mivc.primary_relaxed, mivc.secondary_relaxed) for w in [*acc.W.W, acc.W.E]]
                     + list(mivc.secondary_trace.w.W), f"the Sangria IVC's rounds on {mesh.describe()}")
    log(f"Sangria IVC k={SANGRIA_GOLDEN_K} (mock keys) under mesh_context on {mesh.describe()}, W and E as row "
        f"blocks: both accumulators' digests after new and one fold_step equal the JAX package's frozen ones, "
        f"verify() == []; new {t1 - t0:.4f} s, fold_step {t2 - t1:.4f} s  [{card}]")
    return (t2 - t0, t2 - t1, None)


def mesh_dryrun(mesh, run, card: str) -> tuple:
    """The JAX package's multi-device dry run's Sangria folds (a 3-round SPS
    with a vector lookup, `util/testing.dryrun_sangria_folds`) on its real
    key on cuda:0 under `mesh`: `golden.DRYRUN_MC_FOLDS`, is_sat clean, W
    and E row blocks, m_count launched on the first card only."""
    t0 = time.perf_counter()
    ck = CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc", use_cache=False, device=DEVICE)
    setup = synced_all() - t0
    before = Counter(_build.device_launches)
    with mesh_context(mesh):
        t0 = synced_all()
        digests, errors, acc = run(lambda: dryrun_sangria_folds(ck))
        dt = synced_all() - t0
    counts = {d: k for (e, d), k in (Counter(_build.device_launches) - before).items() if e == "lookup_probe"}
    check(errors == [] and tuple(digests) == golden.DRYRUN_MC_FOLDS,
          f"the dry-run folds on {mesh.describe()}: {digests}, errors {errors}")
    check_row_blocks(mesh, [*acc.W.W, acc.W.E], f"the dry-run folds' rounds on {mesh.describe()}")
    check(set(counts) == {str(mesh.first)}, f"m_count ran off the mesh's first card: {counts}")
    log(f"dry-run Sangria folds (k = 6, 3-round SPS with a vector lookup) under mesh_context on {mesh.describe()}: "
        f"DRYRUN_MC_FOLDS, is_sat clean, W and E row blocks, m_count on {mesh.first} ({counts}); {dt:.4f} s (the "
        f"key's host setup before it {setup:.4f} s)  [{card}]")
    return (dt, dt, None)


def mesh_baseline(pp, card: str) -> dict:
    """The trivial Cyclefold without a mesh in the mesh phase's own run: next
    seconds, spans and peak device memory by card, beside which the mesh's
    are printed."""
    reset_peaks()
    ivc = CyclefoldIVC(pp, IVC_Z0)
    span_seconds()
    nexts, spans = [], []
    for _ in range(IVC_STEPS):
        t0 = synced_all()
        ivc.next()
        nexts.append(synced_all() - t0)
        spans.append(span_seconds())
    peaks = card_peaks()
    log(f"Cyclefold IVC k={IVC_K} without a mesh (the mesh phase's baseline): next "
        + " / ".join(f"{x:.4f}" for x in nexts) + f" s; peak device memory by card {peaks}  [{card}]")
    return {"next": nexts[-1], "nexts": nexts, "spans": spans, "peaks": peaks}


def mesh_sha256(mesh, keys, card: str) -> None:
    """One SHA-256 Cyclefold next (H = 16, 64 rounds, k = 18, the bn256 2^22
    key) under a mesh of every card: W's 16 x 2^18 advice round, the lookup
    rounds and the support trace as row blocks, verify() == [], the peak
    device memory by card beside one card's (PERF.md: 19.58 GB)."""
    ck1_full, _, ck2 = keys
    t0 = synced_all()
    spp = CyclefoldPublicParams(SpreadSha256StepCircuit(bn256_fr, half_bits=SHA_HALF_BITS, rounds=SHA_ROUNDS),
                                SHA_K, ck1_full, ck2)
    t1 = synced_all()
    reset_peaks()
    with mesh_context(mesh):
        ivc = CyclefoldIVC(spp, SHA_Z0)
        t2 = synced_all()
        ivc.next()
        t3 = synced_all()
        peaks = card_peaks()
        check_row_blocks(mesh, [*ivc.primary_trace.w.W, *ivc.self_acc.trace.w.W, ivc.support_acc.W.E],
                         f"the SHA-256 Cyclefold's rounds on {mesh.describe()}")
        errors = ivc.verify()
    check(errors == [], f"the SHA-256 Cyclefold on {mesh.describe()}: verify reported {errors}")
    log(f"SHA-256 Cyclefold k={SHA_K} under mesh_context on {mesh.describe()}: public parameters {t1 - t0:.4f} s, "
        f"new {t2 - t1:.4f} s, next {t3 - t2:.4f} s, verify() == []; peak device memory by card over new and next "
        f"{peaks} (one card: 19.58 GB, PERF.md)  [{card}]")


def mesh_stage_entries(mesh, ck1, rng, record, card: str) -> None:
    """The kernels-line entries of the mesh path at its shapes on `mesh`:
    B2's sort and accumulate and B3's first reduce level on one shard of the
    917,504-scalar commit, B3's combine over every shard's buckets at once
    (one launch for a device's shards), B4 on a device's columns of the 2^20
    four-step and the mid twiddle's mul_rows there, each against its plain
    twin on the same inputs."""
    n = MESH_COMMITS[0]
    S = FR.from_mont(canonical_words(rng, n, ck1.device))
    c = signed_window_bits(-(-n // mesh.size))
    shaped = []
    for i, (Si, Pi) in enumerate(zip(shard_rows(mesh, S), ck1.shards(mesh, n))):
        if i == 0:
            b, stage, plan = msm_stages(BN256_G1, Si, Pi, timed=True, combine=False)
            check(plan.c == c, f"shard 0's window width {plan.c}, the mesh's {c}")
        else:
            plan = bucket_plan(Si, c)
            parts = mk.msm_accumulate(BN256_G1, plan.entries, plan.chunk_start, plan.chunk_len, Pi.x.contiguous(),
                                      Pi.y.contiguous())
            b = Points(*(x.reshape(1, plan.W, plan.B, 8) for x in reduce_segments(BN256_G1, plan.seg_off, parts)))
        shaped.append(b)
    stacked = Points(*(torch.cat(cs) for cs in zip(*shaped)))
    t, W, B = stacked.x.shape[:3]
    t0 = synced()
    plain = mk.msm_combine_plain(BN256_G1, stacked, c)  # one call (~5 s): checked against and timed at once
    plain_ms = (synced() - t0) * 1e3
    res = mk.msm_combine(BN256_G1, stacked, c)
    err = point_err(BN256_G1, res, plain)
    check(err == 0, f"B3 msm_combine disagrees with its twin at {(t, W, B)}")
    sums = ADD_MULS * 2 * t * W * (B - 1)  # as combine_stage counts them
    comb = {"msm_combine": [err, gpu_ms(lambda: mk.msm_combine(BN256_G1, stacked, c)), plain_ms,
                            sums + t * (W - 1) * (DBL_MULS * c + ADD_MULS), 3 * FE * t * W * B + 3 * FE * t]}
    total = gold.identity(BN256_G1.spec)
    for pt in BN256_G1.decode(res):
        total = total.add(pt)
    check(total == best_msm(BN256_G1, S, Points(*(x[:n] for x in ck1.points))),
          "the mesh stages' shards do not add up to best_msm's point")
    for name, (err, ms, plain, muls, nbytes) in (*stage.items(), ("msm_combine", comb["msm_combine"])):
        if f"{name}_mesh" in MESH_ENTRIES:
            record(f"{name}_mesh", "sirius_tpu_torch/csrc/msm.cu", "sirius_tpu/ops/pallas_msm.py:50"
                   if name in B2_NAMES else "sirius_tpu/ops/pallas_msm.py:173", err, ms, plain, muls, nbytes)
    ctx = NTT(FR, NTT_LOG, ck1.device)
    n1, c2 = ctx.n1, ctx.n2 // mesh.size
    A = canonical_words(rng, n1 * c2, ctx.device).reshape(n1, c2, 8)
    args = (FR, A, ctx.rev_n1, ctx.inner[False])
    err = word_err([col_ntt(*args)], [col_ntt_plain(*args)])
    check(err == 0, f"B4 col_ntt at the mesh's pass shape ({n1}, {c2}) is not bit-exact")
    record("col_ntt_mesh", "sirius_tpu_torch/csrc/ntt.cu", "sirius_tpu/ops/pallas_ntt.py:82", err,
           gpu_ms(lambda: col_ntt(*args), reps=20), gpu_ms(lambda: col_ntt_plain(*args), reps=1),
           (n1 // 2 * (n1.bit_length() - 1) - (n1 - 1)) * c2, 2 * FE * n1 * c2 + FE * n1 // 2 + 4 * n1)
    mid = (FR, A.reshape(-1, 8), ctx._mid_columns(False, 0, c2))
    err = word_err([fk.mul_rows(*mid)], [fk.mul_rows_plain(*mid)])
    check(err == 0, f"mul_rows K = 1 at the mesh's mid-twiddle shape ({n1 * c2} x {n1 * c2}) is not bit-exact")
    record("mul_rows_mesh", "sirius_tpu_torch/csrc/field_ops.cu", "scripts/tpu_microbench.py:74", err,
           gpu_ms(lambda: fk.mul_rows(*mid), reps=20), gpu_ms(lambda: fk.mul_rows_plain(*mid), reps=1), n1 * c2,
           3 * FE * n1 * c2)
    log(f"the mesh path's kernels on {mesh.describe()} against their plain twins: B2/B3 on one shard of {n} "
        f"scalars ({Si.shape[0]} a shard, c={c}), B3's combine over the {mesh.size} shards' buckets at once "
        f"({tuple(stacked.x.shape[:3])}), B4 on a device's columns ({n1}, {c2}) and the mid twiddle's mul_rows "
        f"({n1 * c2} rows): every one agrees; the shards add up to best_msm's point  [{card}]")


def mesh_phase(record, kernels, card: str, keys, pp, rng, base: dict | None = None, trace: bool = False) -> None:
    """(a) always: the mesh checks on a virtual mesh of MESH_SHARDS shards on
    cuda:0 (one card's work, so its seconds are no multi-card figure), the
    kernels-line entries of the mesh path with its launches by device; (b)
    on a host with two or more cards: the same checks on a mesh of every
    card, beside (a)'s and the one-card figures, and one SHA-256 Cyclefold
    next under that mesh.  `base`: the trivial Cyclefold's next without a
    mesh earlier in the run (`mesh_baseline` when None); `trace`: trace a
    third next under each mesh."""
    t0 = time.perf_counter()
    profiler.enable()
    base = base or mesh_baseline(pp, card)
    virtual = make_mesh(devices=[DEVICE] * MESH_SHARDS)
    secs, run = mesh_checks(virtual, keys, pp, rng, card, base, trace)
    mesh_stage_entries(virtual, keys[1], rng, record, card)
    for name, entry in MESH_ENTRIES.items():
        by_dev = run.by_device(entry)
        kernels[name].update(launches=sum(by_dev.values()), mesh=virtual.describe(), launches_by_device=by_dev)
        check(kernels[name]["launches"] > 0, f"{entry} never launched on the mesh path on {virtual.describe()}")
    log(f"mesh phase (a), {virtual.describe()}: {time.perf_counter() - t0:.1f} s")
    count = torch.cuda.device_count()
    if count < 2:
        log(f"mesh phase (b): {count} card visible, no mesh of every card to run")
        profiler.enabled = False
        return
    every = make_mesh()
    secs_b, run_b = mesh_checks(every, keys, pp, rng, card, base, trace)
    for name, entry in MESH_ENTRIES.items():
        kernels[name]["launches_every_card"] = run_b.by_device(entry)
    for what, (first, warm, one) in secs_b.items():
        if what.startswith("msm"):
            log(f"mesh phase (b), {what} (standard words given): msm_sharded on {count} cards {first:.4f} s, "
                f"their shards' best_msm one after another {warm:.4f} s, best_msm on one card {one:.4f} s; on "
                f"{virtual.describe()}: {secs[what][0]:.4f} s, {secs[what][1]:.4f} s  [{card}]")
            continue
        log(f"mesh phase (b), {what}: {count} cards ({every.describe()}) {first:.4f} s, warm {warm:.4f} s; "
            f"{virtual.describe()} {secs[what][1]:.4f} s; one card "
            + ("-" if one is None else f"{one:.4f} s") + f"  [{card}]")
    cards = {str(d) for d in every.distinct}
    for entry in ("msm_bucket_scatter", "msm_accumulate", "msm_reduce", "msm_horner"):
        check(set(run_b.by_device(entry)) == cards,
              f"{entry} did not launch on every card of {every.describe()}: {run_b.by_device(entry)}")
    check(len(run_b.by_device("col_ntt")) >= 2, f"col_ntt ran on one card only: {run_b.by_device('col_ntt')}")
    check(set(run_b.by_device("mul_rows")) == cards,
          f"the W conversion did not run on every card of {every.describe()}: {run_b.by_device('mul_rows')}")
    mesh_sha256(every if SHA_ROUND_SIZES[0] % every.size == 0 else virtual, keys, card)
    profiler.enabled = False


def recorder(kernels: dict, imad_rate: float):
    def record(name, source, replaces, err, ms, plain_ms, muls, nbytes, per_mul=FE_MUL_IMADS):
        """One entry of the kernels line; `muls`/`nbytes` are the work of
        the timed call, for its bound."""
        bound_ms, bound_by = bound(muls, nbytes, imad_rate, per_mul)
        kernels[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}

    return record


def card_lines() -> tuple[str, str, float, float]:
    """Log the card, its power limit and clocks, and build the kernels; (the
    nvidia-smi line, the card's label for every log line, the paper rate of
    32-bit integer multiply-adds, the max SM clock in MHz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"card: {smi}; {torch.cuda.device_count()} card(s) visible")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imad_rate = IMADS_PER_CLK_SM * sms * clock_mhz * 1e6
    log(f"{sms} SMs, max SM clock {clock_mhz:.0f} MHz: paper rate {imad_rate:.6e} 32-bit integer multiply-adds/s")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc ran in this process: {_build.built_here()})")
    return smi, card, imad_rate, clock_mhz


def device_json() -> str:
    return json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


def mesh_only() -> int:
    """`python3 chip_smoke.py --mesh-only`: the card lines, the build, the
    keys the mesh phase needs (the bn256 2^22 key and its 2^20 prefix, the
    grumpkin key at 2^17: the support key) and the mesh phase alone, then
    its kernels-line entries, the nvidia-smi line and the device JSON."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's smoke run needs an NVIDIA GPU")
    started = time.perf_counter()
    dev = torch.device(DEVICE)
    smi, card, imad_rate, clock_mhz = card_lines()
    kernels = {}
    t0 = synced()
    ck1_full = CommitmentKey.setup(BN256_G1, PRIMARY_KEY_LOG, b"bench-primary", use_cache=False, device=dev)
    ck2 = CommitmentKey.setup(GRUMPKIN, SUPPORT_KEY_LOG, b"bench-support", use_cache=False, device=dev)
    ck1 = CommitmentKey(BN256_G1, Points(*(c[: 1 << PRIMARY_LOG] for c in ck1_full.points)), ck1_full.label,
                        PRIMARY_LOG)
    log(f"keys: bn256 2^{PRIMARY_KEY_LOG}, grumpkin 2^{SUPPORT_KEY_LOG}: {synced() - t0:.2f} s  [{card}]")
    t0 = synced()
    pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), IVC_K, ck1, ck2)
    log(f"Cyclefold public parameters k={IVC_K}: {synced() - t0:.4f} s")
    mesh_phase(recorder(kernels, imad_rate), kernels, card, (ck1_full, ck1, ck2), pp, np.random.default_rng(SEED),
               trace=True)
    log(f"chip_smoke --mesh-only: {time.perf_counter() - started:.1f} s in all, the build included")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(device_json())
    return 0


def field_op_kernels(record, kernels: dict, card: str, rng) -> None:
    """Phase 14's kernels: addsub_rows and mul_rows (K = 1, nb = n, every
    product) at FIELD_OP_ROWS against their twins, timed from CUDA graphs."""
    dev = torch.device(DEVICE)
    src = "sirius_tpu_torch/csrc/field_ops.cu"
    for n in FIELD_OP_ROWS:
        a, b = FR.random((n,), rng, "cpu").to(dev), FR.random((n,), rng, "cpu").to(dev)
        parts = []
        for op in ("add", "sub"):
            got = fk.addsub_rows(FR, a, b, op)
            err = word_err([got], [fk.addsub_rows_plain(FR, a, b, op)])
            check(err == 0, f"addsub_rows {op} at {n} rows disagrees with its plain twin")
            ms, _ = graph_ms(lambda: fk.addsub_rows(FR, a, b, op), launches=50)
            plain = gpu_ms(lambda: fk.addsub_rows_plain(FR, a, b, op), reps=3)
            record(f"addsub_rows_{op}_{n}", src, "none: XLA's fusion of the jitted field ops", err, ms, plain, 0,
                   FIELD_OP_BYTES * n, per_mul=1)
            parts.append(f"{op} {ms:.6f} ms (plain {plain:.4f} ms)")
        for product in fk.PRODUCTS:
            got = fk.mul_rows(FR, a, b, 1, product=product)
            err = word_err([got], [fk.mul_rows_plain(FR, a, b, 1)])
            check(err == 0, f"mul_rows K = 1 ({product}) at {n} rows disagrees with its plain twin")
            ms, _ = graph_ms(lambda: fk.mul_rows(FR, a, b, 1, product=product), launches=50)
            plain = gpu_ms(lambda: fk.mul_rows_plain(FR, a, b, 1), reps=3)
            record(f"mul_rows_k1_{product}_{n}", src, "scripts/tpu_microbench.py:74", err, ms, plain, n,
                   FIELD_OP_BYTES * n)
            parts.append(f"mul {product} {ms:.6f} ms (plain {plain:.4f} ms)")
        e, m = kernels[f"addsub_rows_add_{n}"], kernels[f"mul_rows_k1_unrolled_{n}"]
        log(f"ring-op kernels at {n} rows, bit-exact against their twins; bound {e['bound_ms']:.6f} ms "
            f"({e['bound_by']}, {FIELD_OP_BYTES} canonical B an element, twice that in int64 words), mul's "
            f"{m['bound_ms']:.6f} ms ({m['bound_by']}): " + "; ".join(parts) + f"  [{card}]")


def bench_configs() -> dict:
    """The benchmark's configurations by name (port_bench/configs/)."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((ROOT / "port_bench" / "configs").glob("*.json"))}


def ring_form(a: torch.Tensor, b: torch.Tensor) -> tuple[str, bool, bool]:
    """A ring op's broadcast form ("rows": both operands of the result's
    shape; "scalar": one a single element; "scalar x scalar"; "empty"; or
    "other"), whether an operand of the result's shape is not contiguous,
    and whether every such operand's rows still lie one row stride apart."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    full = [t for t in (a, b) if t.shape[:-1] == shape]
    if math.prod(shape) == 0:
        form = "empty"
    elif not shape:
        form = "scalar x scalar"
    elif len(full) == 2:
        form = "rows"
    elif min(math.prod(a.shape[:-1]), math.prod(b.shape[:-1])) == 1:
        form = "scalar"
    else:
        form = "other"
    strided = [t for t in full if not t.is_contiguous()]

    def one_stride(t):
        try:
            return t.view(-1, t.shape[-1]).stride(1) == 1
        except RuntimeError:
            return False

    return form, bool(strided), bool(strided) and all(one_stride(t) for t in strided)


@contextmanager
def ring_op_forms():
    """Tallies the ring ops made inside by `ring_form`: {(form, strided,
    at one row stride): count}, and the batch shapes of the "other" ones."""
    forms, others, ring_op = Counter(), Counter(), fk.ring_op

    def tallied(field, op, a, b):
        form = ring_form(a, b)
        forms[form] += 1
        if form[0] == "other":
            others[(tuple(a.shape[:-1]), tuple(b.shape[:-1]))] += 1
        return ring_op(field, op, a, b)

    fk.ring_op = tallied
    try:
        yield forms, others
    finally:
        fk.ring_op = ring_op


def field_op_launches(name: str, cfg: dict, keys, card: str) -> dict:
    """Phase 14's path: the benchmark configuration `name` on its keys; pp,
    new, one next, then one next under torch.profiler: its kernel events
    beside the ring ops' launches in it and their forms."""
    from torch.profiler import ProfilerActivity, profile

    from port_bench.harness import step_circuit, z0_of

    pp = CyclefoldPublicParams(step_circuit(cfg, "sirius_tpu_torch"), cfg["k"], *keys)
    ivc = CyclefoldIVC(pp, z0_of(cfg, SEED, bn256_fr.modulus))
    t0 = synced()
    ivc.next()
    warm = synced() - t0
    before = (Counter(fk.ring_op.launches), Counter(_build.device_launches))
    with ring_op_forms() as (forms, others), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ivc.next()
        wall = synced() - t0
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if not e.name().startswith(("Memcpy", "Memset"))]
    busy = sum(e.duration_ns() for e in events) / 1e9
    ring = Counter(fk.ring_op.launches) - before[0]
    entries = dict(sorted((Counter(_build.device_launches) - before[1]).items()))
    by_name = Counter(e.name()[:60] for e in kernels)
    ops = sum(forms.values())
    tally = "; ".join(f"{form}{', strided' if strided else ''}{' (one row stride)' if one else ''} {k}"
                      for (form, strided, one), k in sorted(forms.items(), key=lambda kv: -kv[1]))
    log(f"{name}: next {warm:.4f} s; one traced next: wall {wall:.4f} s (profiler on), {len(kernels)} kernel events "
        f"(launches_per_step's count), device busy {busy:.4f} s = {100 * busy / wall:.1f}%; ring ops {ops} by form: "
        f"{tally}; other broadcasts by (a, b) batch shape: {dict(others)}; ring-op launches addsub_rows "
        f"{ring['addsub_rows']} + mul_rows {ring['mul_rows']} = {sum(ring.values())} "
        f"({100 * sum(ring.values()) / max(len(kernels), 1):.1f}% of the kernels); the library's launches by (entry, "
        f"card): {entries}; the most launched kernels: "
        + ", ".join(f"{k} {v}" for k, v in by_name.most_common(8)) + f"  [{card}]")
    check(sum(ring.values()) == ops - forms[("empty", False, False)],
          f"{name}: {sum(ring.values())} ring-op launches for {ops} ring ops")
    return {"kernels": len(kernels), "ring_ops": ops, **ring}


def field_ops_phase(record, kernels: dict, card: str, rng, keys: dict) -> None:
    """Phase 14: the ring ops' kernels, then each benchmark configuration's
    traced next on `keys` ({(curve name, log2 size): key}), and the kernels'
    launches on those nexts."""
    field_op_kernels(record, kernels, card, rng)
    launches = {}
    for name, cfg in bench_configs().items():
        ck1, ck2 = (keys[(c["curve"], c["log2_size"])] for c in (cfg["primary_key"], cfg["support_key"]))
        launches[name] = field_op_launches(name, cfg, (ck1, ck2), card)
    for name, e in kernels.items():  # the traced nexts' launches, every shape: mul's on Field.mul's product only
        if name.startswith("addsub_rows_"):
            e["launches"] = sum(v["addsub_rows"] for v in launches.values())
        elif name.startswith(f"mul_rows_k1_{fk.FIELD_PRODUCT}_"):
            e["launches"] = sum(v["mul_rows"] for v in launches.values())
    log(f"phase 14, the ring ops on the benchmark's traced nexts: {launches}  [{card}]")


def field_ops_only() -> int:
    """`python3 chip_smoke.py --field-ops`: the card lines, the build, the
    benchmark's keys (from the key cache where `SIRIUS_TPU_CACHE` holds
    them) and phase 14 alone, then its kernels-line entries, the nvidia-smi
    line and the device JSON."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's smoke run needs an NVIDIA GPU")
    started = time.perf_counter()
    dev = torch.device(DEVICE)
    smi, card, imad_rate, clock_mhz = card_lines()
    kernels, keys = {}, {}
    for cfg in bench_configs().values():
        for c in (cfg["primary_key"], cfg["support_key"]):
            if (c["curve"], c["log2_size"]) not in keys:
                t0 = synced()
                curve = {"bn256": BN256_G1, "grumpkin": GRUMPKIN}[c["curve"]]
                keys[(c["curve"], c["log2_size"])] = CommitmentKey.setup(curve, c["log2_size"], c["label"].encode(),
                                                                         device=dev)
                log(f"key {c['curve']} 2^{c['log2_size']} {c['label']!r}: {synced() - t0:.2f} s")
    field_ops_phase(recorder(kernels, imad_rate), kernels, card, np.random.default_rng(SEED), keys)
    log(f"chip_smoke --field-ops: {time.perf_counter() - started:.1f} s in all, the build included")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(device_json())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's smoke run needs an NVIDIA GPU")

    started = time.perf_counter()
    dev = torch.device(DEVICE)
    smi, card, imad_rate, clock_mhz = card_lines()
    sass = sass_opcodes()
    rng = np.random.default_rng(SEED)
    kernels = {}

    record = recorder(kernels, imad_rate)

    # ---- S4: the build probe ----------------------------------------------------------------
    x = torch.from_numpy(rng.integers(0, 1 << 32, size=(8, 128), dtype=np.int64)).to(dev)
    x[0, 0] = 0xFFFFFFFF  # wraps to 0
    err = word_err([mb.probe_add_one(x)], [mb.probe_add_one_plain(x)])
    check(err == 0, "S4 probe_add_one disagrees with x + 1")
    second = subprocess.run([sys.executable, "-c", "from sirius_tpu_torch.ops import _build\n"
                             "_build.library()\nprint('nvcc ran:', _build.built_here())"],
                            cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(second.returncode == 0 and second.stdout.strip() == "nvcc ran: False",
          f"S4: a second process did not load the cached library: {second.stdout[-500:]} {second.stderr[-2000:]}")
    probe_launches = {}  # S1-S4 have no path but their own timed runs: counted there, after the twin checks
    # one (8, 128) tile: the wrapper's host time per call, then the device's per launch without the host between
    x32 = mb.words_of(x)  # the same words in int32, where x32 + 1 wraps mod 2^32 as the kernel does
    check(torch.equal(mb.u32_of(x32 + 1), mb.probe_add_one(x)), "S4: x32 + 1 differs from probe_add_one")
    mb.probe_add_one.launches = 0
    mb.probe_add_one(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        mb.probe_add_one(x)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    eager_ms = gpu_ms(lambda: mb.probe_add_one(x), reps=200)
    ms, replayed = graph_ms(lambda: mb.probe_add_one(x))
    probe_launches["probe_add_one"] = mb.probe_add_one.launches + replayed
    lib_ms, _ = graph_ms(lambda: x32 + 1)
    lib_eager_ms = gpu_ms(lambda: x32 + 1, reps=200)
    plain = gpu_ms(lambda: mb.probe_add_one_plain(x), reps=200)
    record("probe_add_one", "sirius_tpu_torch/csrc/microbench.cu", "scripts/lower_dump.py:14", err, ms, plain,
           x.numel(), 8 * x.numel(), per_mul=1)
    kernels["probe_add_one"]["library_ms"] = lib_ms
    log(f"S4 probe_add_one (8, 128): equals x + 1 mod 2^32 and x32 + 1; a second process loaded the cached library "
        f"without nvcc; the wrapper's host time {host_us:.3f} us per call (200 calls); 200 calls back to back on "
        f"CUDA events {eager_ms:.6f} ms per call; device per launch from a CUDA graph of 200 launches "
        f"{ms:.6f} ms = {ms * 1e3:.3f} us (a launch's latency); x32 + 1 (int32, one PyTorch call) {lib_ms:.6f} ms "
        f"per call from a graph, {lib_eager_ms:.6f} ms back to back; plain {plain:.6f} ms  [{card}]")

    # ---- S2/S3: field and integer rates against the paper rate --------------------------------
    def random_elements(gen, n):
        """n canonical Montgomery words below 2^252 (< p for both bn256 fields)."""
        w = gen.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
        w[:, 7] &= 0x0FFFFFFF
        return torch.from_numpy(w).to(dev)

    # S2 on the unrolled product (the NTT's multiply), the carry-chain one (B1's walk, B2, B4) and the wide one
    # (B1's batched madd): mul_chain, mul_chain_cc, mul_chain_wide
    for field in (FR, FQ):
        a2, b2 = random_elements(rng, S2_N), random_elements(rng, S2_N)
        want = mb.mul_chain_plain(field, a2, b2, S2_K)
        for product, name in S2_ENTRIES.items():
            err = word_err([mb.mul_chain(field, a2, b2, S2_K, product=product)], [want])
            check(err == 0, f"S2 mul_chain on {field}, {product} product, is not bit-exact")
            # the kernel takes about the wrapper's host time per call: timed from a CUDA graph of its launches
            fk.mul_rows.launches = 0
            ms, replayed = graph_ms(lambda: mb.mul_chain(field, a2, b2, S2_K, product=product), launches=50)
            eager = gpu_ms(lambda: mb.mul_chain(field, a2, b2, S2_K, product=product), reps=50)
            if field is FR:
                probe_launches[name] = fk.mul_rows.launches + replayed
            plain = gpu_ms(lambda: mb.mul_chain_plain(field, a2, b2, S2_K), reps=3)
            rate, paper = S2_N * S2_K / (ms / 1e3), imad_rate / FE_MUL_IMADS
            log(f"S2 mul_chain {field.spec.name} 2^17 x K={S2_K}, {product} product: bit-exact; kernel {ms:.6f} ms "
                f"per launch from a CUDA graph = {rate:.6e} Montgomery mul/s = {100 * rate / paper:.2f}% of the paper "
                f"rate {paper:.6e} ({FE_MUL_IMADS} multiply-adds per mul); back to back {eager:.6f} ms per call; "
                f"plain {plain:.4f} ms  [{card}]")
            ms_long = gpu_ms(lambda: mb.mul_chain(field, a2, b2, LONG_K, product=product), reps=10)
            rate = S2_N * LONG_K / (ms_long / 1e3)
            log(f"S2 mul_chain {field.spec.name} 2^17 x K={LONG_K}, {product} product: {ms_long:.6f} ms = {rate:.6e} "
                f"Montgomery mul/s = {100 * rate / paper:.2f}% of the paper rate  [{card}]")
            if field is FR:
                record(name, "sirius_tpu_torch/csrc/field_ops.cu", "scripts/tpu_microbench.py:74", err, ms,
                       plain, S2_N * S2_K, 3 * FE * S2_N)
    # every product on the edge values 0, 1, p - 1 and R mod p, all pairs, K = 1 and 3
    for field in (FR, FQ):
        edge = [0, 1, field.p - 1, (1 << 256) % field.p]
        ea = torch.from_numpy(ints_to_words(edge)).to(dev)
        pairs = ea.repeat_interleave(len(edge), 0)  # row i times edge[i mod 4]: every pair
        for K in (1, 3):
            want = fk.mul_rows_plain(field, pairs, ea, K)
            for product in fk.PRODUCTS:
                check(torch.equal(fk.mul_rows(field, pairs, ea, K, product=product), want),
                      f"the {product} product on {field} differs from the twin on the edge values (K = {K})")
    log(f"every product {fk.PRODUCTS} equals the twin on 0, 1, p - 1, R mod p, all pairs, both fields")
    for product in fk.PRODUCTS:
        log(f"mul_rows at K > 1 (S2's instance, one element a thread) on the {product} product: "
            f"{fk.mul_rows_kernel_attrs(product)}")
    a3 = mb.words_of(torch.from_numpy(rng.integers(0, 1 << 32, size=S3_N, dtype=np.int64)).to(dev))  # u32 bits
    errs, outs = {}, {}
    for op in ("mul", "add"):
        outs[op] = mb.raw_u32(a3, op, S3_REPS)
        errs[op] = word_err([outs[op]], [mb.raw_u32_plain(a3, op, S3_REPS)])
        check(errs[op] == 0, f"S3 raw_u32 {op} disagrees with its twin")
    # the one PyTorch call computing each function folds the chain the probe times: b = a + 64 a, b = a^65
    library = {"mul": lambda: a3 ** (S3_REPS + 1), "add": lambda: a3 * (S3_REPS + 1)}
    wraps = {op: torch.equal(fn(), outs[op]) for op, fn in library.items()}
    # the SM clock and power while the long chain runs: ~0.4 s of launches queued, nvidia-smi read meanwhile
    for _ in range(400):
        mb.raw_u32(a3, "mul", LONG_REPS)
    load = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.split(",")
    torch.cuda.synchronize()
    load_mhz = float(load[0])
    log(f"S3 under load (the mul chain x {LONG_REPS} queued): SM clock {load_mhz:.0f} MHz, power {load[1].strip()} W "
        f"(the paper rate takes the max clock {clock_mhz:.0f} MHz)  [{card}]")
    # the share of the paper rate counts the instructions the card issues: the op's opcode in the SASS of the
    # instance that ran (FIXED: 64 reps, straight-line) over the source ops there, the mul instance's IMAD
    # count (one IMAD a multiply); ptxas fuses two dependent adds into one IADD3
    opcode = {"mul": "IMAD", "add": "IADD3"}
    raw_sass = {(op, fixed): sum((v for k, v in (sass or {}).items() if f"raw_u32_kernelILi{i}ELb{int(fixed)}E" in k),
                                 Counter()) for i, op in enumerate(mb.RAW_OPS) for fixed in (True, False)}

    def share(rate, op, fixed):
        src_ops = raw_sass["mul", fixed].get("IMAD", 0)
        if not src_ops:
            return "share of the paper rate not measured (no SASS)"
        per_op = raw_sass[op, fixed].get(opcode[op], 0) / src_ops
        r = rate * per_op / imad_rate
        return (f"{rate * per_op:.6e} {opcode[op]}/s issued ({per_op:.4f} a {op}) = {100 * r:.2f}% of the "
                f"paper rate {imad_rate:.6e} ({100 * r * clock_mhz / load_mhz:.2f}% at the clock under load)")

    # the kernel at 64 reps takes about the wrapper's host time per call: timed from a CUDA graph of its launches
    mb.raw_u32.launches = 0
    replayed = 0
    for op, err in errs.items():
        eager = gpu_ms(lambda: mb.raw_u32(a3, op, S3_REPS), reps=50)
        ms, n = graph_ms(lambda: mb.raw_u32(a3, op, S3_REPS), launches=50)
        replayed += n
        plain = gpu_ms(lambda: mb.raw_u32_plain(a3, op, S3_REPS), reps=3)
        lib_ms = graph_ms(library[op], launches=50)[0] if wraps[op] else None
        call = "a32 ** 65" if op == "mul" else "a32 * 65"
        rate = S3_N * S3_REPS / (ms / 1e3)
        log(f"S3 raw_u32 {op} 2^22 x {S3_REPS} (int32 words): exact; kernel {ms:.6f} ms per launch from a CUDA graph "
            f"= {rate:.6e} u32 {op}/s, {share(rate, op, True)}; back to back {eager:.6f} ms per call; plain "
            f"{plain:.4f} ms; "
            + (f"{call} (one PyTorch call, folding the chain) bit-equal, {lib_ms:.6f} ms from a graph" if wraps[op]
               else f"{call} is not bit-equal on the card: no PyTorch call computes this function") + f"  [{card}]")
        ms_long = gpu_ms(lambda: mb.raw_u32(a3, op, LONG_REPS), reps=10)
        rate = S3_N * LONG_REPS / (ms_long / 1e3)
        log(f"S3 raw_u32 {op} 2^22 x {LONG_REPS}: {ms_long:.6f} ms = {rate:.6e} u32 {op}/s, "
            f"{share(rate, op, False)}  [{card}]")
        if op == "mul":
            record("raw_u32", "sirius_tpu_torch/csrc/microbench.cu", "scripts/tpu_microbench.py:102", err, ms,
                   plain, S3_N * S3_REPS, 8 * S3_N, per_mul=1)
            kernels["raw_u32"]["library_ms"] = lib_ms
    probe_launches["raw_u32"] = mb.raw_u32.launches + replayed

    # the latency of one dependent product: one thread, K = LATENCY_K (S2's kernel)
    a1, b1 = random_elements(rng, 1), random_elements(rng, 1)
    lat = {}
    for product in fk.PRODUCTS:
        err = word_err([mb.mul_chain(FR, a2, b2, S2_K, product=product)], [mb.mul_chain_plain(FR, a2, b2, S2_K)])
        check(err == 0, f"mul_chain ({product} product) at K = {S2_K} is not bit-exact")
        lat[product] = gpu_ms(lambda: mb.mul_chain(FR, a1, b1, LATENCY_K, product=product), reps=5) * 1e3 / LATENCY_K
    chains = [mb.mul_chain(FR, a1, b1, LATENCY_K, product=product) for product in fk.PRODUCTS]
    check(all(torch.equal(chains[0], x) for x in chains[1:]), "the products' chains differ")
    latency_us = lat["cc_rolled"]  # B3's window sums, Horner and reduce run on the rolled carry-chain product
    log(f"latency probe (one element, K = {LATENCY_K} dependent bn256 Fr products): "
        + ", ".join(f"{k} {v:.6f} us = {v * clock_mhz:.0f} SM cycles" for k, v in lat.items())
        + f" per product at the max clock; all bit-exact at K = {S2_K}  [{card}]")
    log(f"launch counts of the probes' timed runs: {probe_launches}")
    for name, count in probe_launches.items():
        check(count > 0, f"probe {name} never launched in its timed runs")

    def random_scalars(gen, shape):
        """Standard-form word tensor of 252-bit scalars (bench.py's draw)."""
        limbs = gen.integers(0, 1 << 16, size=(*shape, 16), dtype=np.uint32)
        limbs[..., 15] &= 0x0FFF
        return limbs, torch.from_numpy(limbs_to_words(limbs)).to(dev)

    def ints_of(limbs):
        return [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in limbs]

    # ---- keys -------------------------------------------------------------------
    # each setup's peak device memory (maps of DEVICE_SETUP_CHUNK points) and its square roots' span
    profiler.enable()
    keys = []
    for curve, log_n, label in ((BN256_G1, PRIMARY_KEY_LOG, b"bench-primary"), (GRUMPKIN, GRUMPKIN_KEY_LOG,
                                                                                 b"bench-support")):
        span_seconds()
        torch.cuda.reset_peak_memory_stats()
        t0 = synced()
        keys.append(CommitmentKey.setup(curve, log_n, label, use_cache=False, device=dev))
        dt = synced() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"key {curve.spec.name} 2^{log_n}: {dt:.2f} s, peak device memory {peak} B = {peak / 2**30:.3f} GiB "
            f"(max_memory_allocated; chunks of {DEVICE_SETUP_CHUNK} points); spans (host seconds): "
            + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    profiler.enabled = False
    ck1_full, ck2 = keys
    # the earlier phases' bn256 key: the first 2^20 points (a SHAKE-256 stream over the label: a 2^20 setup's points)
    ck1 = CommitmentKey(BN256_G1, Points(*(c[: 1 << PRIMARY_LOG] for c in ck1_full.points)), ck1_full.label,
                        PRIMARY_LOG)
    sup = Points(*(c[: 1 << SUPPORT_KEY_LOG] for c in ck2.points))  # the support key: the Cyclefold phases' points
    log(f"keys: bn256 2^{PRIMARY_KEY_LOG} (its first 2^{PRIMARY_LOG} points are the bn256 key of every phase before "
        f"the lookup IVCs), grumpkin 2^{GRUMPKIN_KEY_LOG} (its first 2^{SUPPORT_KEY_LOG} points are the support key)")
    # spot-check the device hash-to-curve against the host map
    for ck, curve in ((ck1, BN256_G1), (ck2, GRUMPKIN)):
        stream = hashlib.shake_256(ck.label).digest(64 * 4)
        want = [hash_bytes_to_point(curve.spec, stream[64 * i : 64 * (i + 1)]) for i in range(4)]
        check(curve.decode(Points(*(c[:4] for c in ck.points))) == want, f"{curve} key prefix vs host map")

    # ---- B1: madd, bit-exact on 2^16 pairs per curve ------------------------------------
    for ck, curve in ((ck1, BN256_G1), (ck2, GRUMPKIN)):
        n = B1_PAIRS
        K = ck.points
        P = curve.dbl(Points(*(c[n : 2 * n] for c in K)))  # Jacobian, z != 1
        P = Points(*(c.clone() for c in P))
        ident = curve.identity((64,), dev)
        for c, i in zip(P, ident):
            c[:64] = i  # identity rows: the result must be Q
        qx, qy = K.x[:n].contiguous(), K.y[:n].contiguous()
        err = word_err(madd_mod.madd_batch(curve, P, qx, qy), madd_mod.madd_plain(curve, P, qx, qy))
        check(err == 0, f"B1 madd on {curve} is not bit-exact (max err {err})")
        log(f"B1 madd {curve.spec.name} {n} pairs: bit-exact")

    # B1 at the support cross-term step shape: one lane per (term, window, group)
    lanes = CROSS_TERMS * (256 // MANY_WINDOW_BITS) * MANY_GROUPS
    K = sup
    P = GRUMPKIN.dbl(Points(*(c[-lanes:] for c in K)))
    qx, qy = K.x[:lanes].contiguous(), K.y[:lanes].contiguous()
    err = word_err(madd_mod.madd_batch(GRUMPKIN, P, qx, qy), madd_mod.madd_plain(GRUMPKIN, P, qx, qy))
    check(err == 0, "B1 madd at the step shape is not bit-exact")
    # off the main path since msm_many walks its buckets in one launch; the kernel takes about the wrapper's host
    # time per call: timed from a CUDA graph of its launches
    madd_mod.madd_batch.launches = 0
    ms, replayed = graph_ms(lambda: madd_mod.madd_batch(GRUMPKIN, P, qx, qy), launches=20)
    eager = gpu_ms(lambda: madd_mod.madd_batch(GRUMPKIN, P, qx, qy), reps=20)
    probe_launches["madd"] = madd_mod.madd_batch.launches + replayed
    plain = gpu_ms(lambda: madd_mod.madd_plain(GRUMPKIN, P, qx, qy), reps=3)
    record("madd", "sirius_tpu_torch/csrc/madd.cu", "sirius_tpu/ops/pallas_madd.py:136", err, ms, plain,
           MADD_MULS * lanes, 8 * FE * lanes)
    b1 = kernels["madd"]
    log(f"B1 madd {lanes} lanes (the wide product): bit-exact; kernel {ms:.6f} ms per launch from a CUDA graph, "
        f"back to back {eager:.6f} ms per call, plain {plain:.4f} ms, bound "
        f"{b1['bound_ms']:.7f} ms ({b1['bound_by']}; the bytes at the int64 words, 8 x 64 B a lane: "
        f"{8 * 2 * FE * lanes / HBM_BYTES_PER_S * 1e3:.7f} ms)  [{card}]")

    # ---- B2 + B3 at the support W-commit shape (7 x 2^14 grumpkin scalars) ----------------
    _, Sw = random_scalars(rng, (W_COMMIT_N,))
    pw = Points(*(c[:W_COMMIT_N] for c in ck2.points))
    res, stage, plan = msm_stages(GRUMPKIN, Sw, pw, timed=True)
    check(GRUMPKIN.decode(res)[0] == best_msm(GRUMPKIN, Sw, pw), "W-commit stages disagree with best_msm")
    # B3's combine at msm_many's shape, on doubled key points as bucket sums
    t, W, B, c = MANY_SHAPE
    idx = torch.from_numpy(rng.integers(0, 1 << SUPPORT_KEY_LOG, size=t * W * B)).to(dev)
    many = Points(*(a.reshape(t, W, B, 8) for a in GRUMPKIN.dbl(Points(*(k[idx] for k in sup)))))
    many_stage, _ = combine_stage(GRUMPKIN, many, c, timed=True)
    stage["msm_combine_many"] = many_stage["msm_combine"]
    for name, (err, ms, plain, muls, nbytes) in stage.items():
        record(name, "sirius_tpu_torch/csrc/msm.cu",
               "sirius_tpu/ops/pallas_msm.py:50" if name in B2_NAMES else "sirius_tpu/ops/pallas_msm.py:173",
               err, ms, plain, muls, nbytes)
    log(f"B2/B3 at {W_COMMIT_N} grumpkin points (c={plan.c}, W={plan.W}, B={plan.B}) and the combine at "
        f"msm_many's {MANY_SHAPE[:3]}: every stage agrees with its twin; "
        + ", ".join(f"{k} {v[1]:.6f} ms (plain {v[2]:.4f} ms, bound {kernels[k]['bound_ms']:.7f} ms)"
                    for k, v in stage.items()) + f"  [{card}]")
    chain = {"msm_reduce": (log2_ceil(FAN_IN), 0), **combine_chains(plan.W, plan.B, plan.c)}
    chain["msm_combine_many"] = combine_chains(*MANY_SHAPE[1:])["msm_combine"]
    floors = []
    for k, (adds, dbls) in chain.items():
        muls, levels = ADD_MULS * adds + DBL_MULS * dbls, ADD_LEVELS * adds + DBL_LEVELS * dbls
        floors.append(f"{k} ({adds} adds, {dbls} doublings): {muls} products x {latency_us:.6f} us = "
                      f"{muls * latency_us / 1e3:.6f} ms, {levels} levels x {latency_us:.6f} us = "
                      f"{levels * latency_us / 1e3:.6f} ms (kernel {stage[k][1]:.6f} ms, bound "
                      f"{kernels[k]['bound_ms']:.7f} ms)")
    log("serial floors of the longest dependent chain at the rolled carry-chain product's latency, its products one after "
        "another and its dependency levels one after another: " + "; ".join(floors) + f"  [{card}]")

    # best_msm at 2^12 against the big-integer reference
    n = 1 << MSM_CHECK_LOG
    limbs, S = random_scalars(rng, (n,))
    pts = Points(*(c[:n] for c in ck1.points))
    res, _, _ = msm_stages(BN256_G1, S, pts)
    want = reference_msm(ints_of(limbs), BN256_G1.decode(pts))
    check(best_msm(BN256_G1, S, pts) == want, "best_msm 2^12 disagrees with the reference MSM")
    check(BN256_G1.decode(res)[0] == want, "B2/B3 stages at 2^12 disagree with the reference MSM")
    log("B2/B3 best_msm 2^12 bn256: every stage agrees with its twin; result equals the reference MSM")

    # B1's bucket walk at msm_many's cross-term shape, then msm_many (B1 path) against best_msm (B2/B3 path)
    _, Sb = random_scalars(rng, (CROSS_TERMS, CROSS_N))
    pts2 = Points(*(c[:CROSS_N] for c in ck2.points))
    walk = (GRUMPKIN, Sb, pts2.x.contiguous(), pts2.y.contiguous(), MANY_GROUPS, MANY_WINDOW_BITS)
    err = word_err(madd_mod.madd_buckets(*walk), madd_mod.madd_buckets_plain(*walk))
    check(err == 0, "B1 madd_buckets is not bit-exact against its twin at msm_many's shape")
    ms = gpu_ms(lambda: madd_mod.madd_buckets(*walk), reps=10)
    plain = gpu_ms(lambda: madd_mod.madd_buckets_plain(*walk), reps=1)
    # needed products: a madd per live digit but the first of each (t, w, g, v) bucket, which copies the point
    dg = madd_mod.extract_digits(Sb, MANY_WINDOW_BITS).reshape(CROSS_TERMS, -1, MANY_GROUPS, CROSS_N // MANY_GROUPS)
    B_many = (1 << MANY_WINDOW_BITS) - 1
    live = int((dg > 0).sum())
    touched = sum(int((dg == v).any(-1).sum()) for v in range(1, B_many + 1))
    record("madd_buckets", "sirius_tpu_torch/csrc/madd.cu", "sirius_tpu/ops/pallas_madd.py:136", err, ms, plain,
           MADD_MULS * (live - touched), FE * CROSS_TERMS * CROSS_N + 2 * FE * CROSS_N
           + 3 * FE * CROSS_TERMS * dg.shape[1] * B_many * MANY_GROUPS)
    mbk = kernels["madd_buckets"]
    log(f"B1 madd_buckets {CROSS_TERMS} x 2^14 grumpkin ({live} live digits, {touched} buckets touched): bit-exact; "
        f"kernel {ms:.6f} ms, plain {plain:.4f} ms, bound {mbk['bound_ms']:.6f} ms ({mbk['bound_by']})  [{card}]")
    before = (madd_mod.madd_buckets.launches, madd_mod.madd_batch.launches)
    many = msm_many(GRUMPKIN, Sb, pts2)
    after = (madd_mod.madd_buckets.launches, madd_mod.madd_batch.launches)
    check(after == (before[0] + 1, before[1]), f"msm_many launched madd_buckets / madd {after} from {before}")
    check(many == [best_msm(GRUMPKIN, Sb[i], pts2) for i in range(CROSS_TERMS)],
          "msm_many (B1 path) disagrees with best_msm (B2/B3 path)")
    log(f"msm_many {CROSS_TERMS} x 2^14 grumpkin: one madd_buckets launch, no madd launch; agrees with best_msm")

    # ---- 2^20 bn256 commit ---------------------------------------------------------------
    n = 1 << PRIMARY_LOG
    limbs, S = random_scalars(np.random.default_rng(42), (n,))
    mpre = 64
    prefix = Points(*(c[:mpre] for c in ck1.points))
    want = reference_msm(ints_of(limbs[:mpre]), BN256_G1.decode(prefix))
    check(best_msm(BN256_G1, S[:mpre], prefix) == want, "2^20 commit: reference prefix check")
    got = best_msm(BN256_G1, S, ck1.points)
    res, _, plan = msm_stages(BN256_G1, S, ck1.points)
    check(BN256_G1.decode(res)[0] == got, "2^20 commit: best_msm disagrees with the twin-checked stages")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best_msm(BN256_G1, S, ck1.points)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"2^20 bn256 MSM (c={plan.c}): prefix equals the reference, every stage agrees with its twin; "
        f"warm {dt:.4f} s = {n / dt:.0f} pts/s  [{card}]")

    # ---- the NTT at 2^20 on bn256 Fr (bench.py's inputs) ---------------------------------------
    n = 1 << NTT_LOG
    xs = [int(v) for v in np.random.default_rng(7).integers(0, 2**62, size=n)]
    a = FR.encode(xs, dev)
    chk = NTT(FR, NTT_LOG, dev)  # a context of its own: the path below builds its mid twiddles itself
    n1, n2 = chk.n1, chk.n2
    half = n1 // 2
    col_ntt, col_ntt_plain = ntt_kernels.col_ntt, ntt_kernels.col_ntt_plain
    for inverse in (False, True):
        M, inner, T = a.reshape(n1, n2, 8), chk.inner[inverse], chk.mid_twiddle(inverse)
        A = col_ntt(FR, M, chk.rev_n1, inner)
        err1 = word_err([A], [col_ntt_plain(FR, M, chk.rev_n1, inner)])
        D = col_ntt(FR, M, chk.rev_n1, inner, T)  # the epilogue pass: times T, transposed
        errd = word_err([D], [col_ntt_plain(FR, M, chk.rev_n1, inner, T)])
        B = fk.mul_rows(FR, A.reshape(n, 8), T)
        errm = word_err([B], [fk.mul_rows_plain(FR, A.reshape(n, 8), T)])
        rep = (FR, A.reshape(n, 8), T[: n // MID_REP], 1, MID_REP)  # b of n / 4 rows, each repeated 4 times
        errr = word_err([fk.mul_rows(*rep)], [fk.mul_rows_plain(*rep)])
        check(torch.equal(D, B.reshape(n1, n2, 8).transpose(0, 1).contiguous()),
              "the epilogue pass differs from col_ntt -> mul_rows -> transpose on the card")
        E = col_ntt(FR, D, chk.rev_n2, chk.outer[inverse])
        err2 = word_err([E], [col_ntt_plain(FR, D, chk.rev_n2, chk.outer[inverse])])
        check(err1 == errd == err2 == errm == errr == 0, f"B4 col_ntt / its epilogue / mul_rows K = 1 not bit-exact "
              f"at ({n1}, {n2}), inverse={inverse}: {err1}, {errd}, {err2}, {errm}, {errr}")
        check(torch.equal(E.reshape(n, 8), chk.fft(a, inverse)), "the checked stages disagree with NTT.fft")
        # mul_rows K = 1 at the NTT path's own shapes: the coset powers zeta^(i mod 3) (2^20 rows against 3)
        # and the mid twiddle's last doubling step (its rows o1 < n1 / 2 times w^(+-n1 i2 / 2))
        coset = (FR, a, (chk.zeta_inv_pows if inverse else chk.zeta_pows))
        errc = word_err([fk.mul_rows(*coset)], [fk.mul_rows_plain(*coset)])
        half_rows = n1 // 2 * n2
        dbl = (FR, T[:half_rows], T[half_rows : half_rows + n2])  # row n1 / 2 of T: w^(+-n1 i2 / 2)
        D2 = fk.mul_rows(*dbl)
        errs = word_err([D2], [fk.mul_rows_plain(*dbl)])
        check(errc == errs == 0, f"mul_rows K = 1 not bit-exact at the coset shape ({n} x 3) or the doubling step "
              f"({half_rows} x {n2}), inverse={inverse}: {errc}, {errs}")
        if not inverse:
            # unscaled, the step gives T's upper rows (the inverse's T carries 1/n in both factors)
            check(torch.equal(D2, T[half_rows:]), "the doubling step does not give the mid twiddle's upper rows")
            args = (FR, M, chk.rev_n1, inner)
            ms = gpu_ms(lambda: col_ntt(*args), reps=20)
            plain = gpu_ms(lambda: col_ntt_plain(*args), reps=1)
            # every butterfly multiplies but those with twiddle w^0 = 1: n1 - 1 of them per column
            muls = (half * (n1.bit_length() - 1) - (n1 - 1)) * n2
            record("col_ntt", "sirius_tpu_torch/csrc/ntt.cu", "sirius_tpu/ops/pallas_ntt.py:82", err1, ms, plain,
                   muls, 2 * FE * n + FE * half + 4 * n1)
            ms_d = gpu_ms(lambda: col_ntt(*args, T), reps=20)
            plain_d = gpu_ms(lambda: col_ntt_plain(*args, T), reps=1)
            record("col_ntt_mid", "sirius_tpu_torch/csrc/ntt.cu", "sirius_tpu/ops/pallas_ntt.py:82", errd, ms_d,
                   plain_d, muls + n, 3 * FE * n + FE * half + 4 * n1)
            ms_c = gpu_ms(lambda: fk.mul_rows(*coset), reps=20)
            plain_c = gpu_ms(lambda: fk.mul_rows_plain(*coset), reps=1)
            record("mul_rows", "sirius_tpu_torch/csrc/field_ops.cu", "scripts/tpu_microbench.py:74", errc, ms_c,
                   plain_c, n, 2 * FE * n + 3 * FE)
            ms_s = gpu_ms(lambda: fk.mul_rows(*dbl), reps=20)
            mid = (FR, A.reshape(n, 8), T)
            ms_mid = gpu_ms(lambda: fk.mul_rows(*mid), reps=20)
            ms_rep = gpu_ms(lambda: fk.mul_rows(*rep), reps=20)
            b4, b4d, bm = kernels["col_ntt"], kernels["col_ntt_mid"], kernels["mul_rows"]
            log(f"B4 col_ntt ({n1}, {n2}): kernel {ms:.6f} ms, plain {plain:.4f} ms, bound {b4['bound_ms']:.6f} ms "
                f"({b4['bound_by']}); its epilogue pass (times T, transposed) {ms_d:.6f} ms, plain {plain_d:.4f} ms, "
                f"bound {b4d['bound_ms']:.6f} ms ({b4d['bound_by']}); mul_rows K=1 at the coset shape (2^20 x 3) "
                f"{ms_c:.6f} ms, plain {plain_c:.4f} ms, bound {bm['bound_ms']:.6f} ms ({bm['bound_by']}; at the "
                f"int64 words {2 * 2 * FE * n / HBM_BYTES_PER_S * 1e3:.6f} ms); the doubling step ({half_rows} x {n2}) "
                f"{ms_s:.6f} ms; 2^20 x 2^20 (rep = 1) {ms_mid:.6f} ms (int64 floor "
                f"{6 * FE * n / HBM_BYTES_PER_S * 1e3:.6f} ms); rep = {MID_REP} {ms_rep:.6f} ms  [{card}]")
    log(f"B4 col_ntt at both pass shapes ({n1} x {n2}, {n2} x {n1}) and its epilogue pass, forward and inverse "
        f"tables, and mul_rows K = 1 (the coset shape, the doubling step, nb = n with rep 1 and {MID_REP}): "
        f"bit-exact against their twins")

    # the NTT path (launch counts from here)
    counts = lambda: (col_ntt.launches, col_ntt.mid_launches, fk.mul_rows.launches)  # noqa: E731
    col_ntt.launches = col_ntt.mid_launches = fk.mul_rows.launches = 0
    t0 = time.perf_counter()
    ctx = NTT(FR, NTT_LOG, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctx.mid_twiddle(False)
    ctx.mid_twiddle(True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for inverse in (False, True):
        before = counts()
        ctx.fft(a, inverse)
        got = tuple(x - y for x, y in zip(counts(), before))
        check(got == (2, 1, 0), f"the 2^20 {'inverse' if inverse else 'forward'} transform launched (col_ntt, its "
              f"epilogue, mul_rows) = {got}, not (2, 1, 0)")
    out = ctx.fft(a)
    check(torch.equal(ctx.ifft(out), a), "2^20 ifft(fft(a)) != a")
    coset = ctx.coset_fft(a)
    check(torch.equal(ctx.coset_ifft(coset), a), "2^20 coset_ifft(coset_fft(a)) != a")
    p, w = FR.p, gold.omega_for_k(bn256_fr, NTT_LOG)
    zpow = [pow(bn256_fr.zeta, i, p) for i in range(3)]
    for j in (0, 1, 123457):
        wj, cur, acc, cacc = pow(w, j, p), 1, 0, 0
        for i, v in enumerate(xs):
            acc += v * cur
            cacc += v * zpow[i % 3] * cur
            cur = cur * wj % p
        check(FR.decode(out[j : j + 1]) == [acc % p] and FR.decode(coset[j : j + 1]) == [cacc % p],
              f"2^20 fft / coset_fft at {j} differ from the direct sums")
    got8 = FR.decode(NTT(FR, 3, dev).fft(FR.encode(list(range(8)), dev)))
    check(got8 == GOLDEN_FFT8, "NTT k = 3 (R = 1 route) differs from the reference vector")
    x12 = [int(v) for v in np.random.default_rng(12).integers(0, 2**62, size=1 << 12)]
    check(FR.decode(NTT(FR, 12, dev).fft(FR.encode(x12, dev))) == gold.fft(x12, bn256_fr),
          "NTT k = 12 differs from gold.fft")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ctx.fft(a)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t3
    fwd_ms = gpu_ms(lambda: ctx.fft(a), reps=10)
    inv_ms = gpu_ms(lambda: ctx.ifft(a), reps=10)
    ntt_launches = dict(zip(("col_ntt", "col_ntt_mid", "mul_rows"), counts()))
    ntt_launches["col_ntt"] -= ntt_launches["col_ntt_mid"]  # the plain pass's launches
    log(f"NTT 2^20 bn256 Fr: context {t1 - t0:.4f} s, mid-twiddle set-up (both directions) {t2 - t1:.4f} s; "
        f"the forward and inverse transforms launch 2 col_ntt (one its epilogue pass) and no mul_rows; fft/ifft and "
        f"coset round trips exact, spot values equal the direct sums, k = 3 equals the reference vector, k = 12 "
        f"equals gold.fft; warm forward {dt:.6f} s = {n / dt:.6e} elements/s (CUDA events forward {fwd_ms:.6f} ms "
        f"= {n / (fwd_ms / 1e3):.6e} elements/s, inverse {inv_ms:.6f} ms)  [{card}]")
    log(f"launch counts on the NTT path: {ntt_launches}")
    for name, count in ntt_launches.items():
        check(count > 0, f"kernel {name} never launched on the NTT path")

    # ---- the support-fold chain (launch counts from here) -------------------------------------
    t0 = time.perf_counter()
    S_sup, sup_taped = support_structure()  # the dry synthesis traces the support tape
    t_sup = time.perf_counter() - t0
    counters = (madd_mod.madd_buckets, bucket_plan, mk.msm_accumulate, mk.msm_reduce, mk.msm_window_sums,
                mk.msm_combine)
    for fn in (*counters, madd_mod.madd_batch):
        fn.launches = 0
    chain = SupportFoldChain(ck2, S_sup, sup_taped)
    phases = {"witness": "support_witness", "sps": "support_sps", "prove": "support_sangria_prove"}
    totals = dict.fromkeys(phases, 0.0)
    profiler.enable()
    span_seconds()
    for i in range(FOLDS):  # each phase's host seconds from its span (no synchronize closes them)
        chain.fold(random_input(rng))
        spans = span_seconds()
        secs = {k: spans.get(name, 0.0) for k, name in phases.items()}
        for k, v in secs.items():
            totals[k] += v
        log(f"fold {i}: " + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items()) + f"  [{card}]")
    profiler.enabled = False
    t0 = time.perf_counter()
    check(chain.verify() == chain.acc.U, "verify does not replay the prover's accumulator")
    t1 = time.perf_counter()
    errors = chain.is_sat()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(errors == [], f"is_sat reported {errors}")
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"support chain {FOLDS} folds k=14: witness {totals['witness']:.4f} s, sps {totals['sps']:.4f} s, "
        f"prove {totals['prove']:.4f} s, verify {t1 - t0:.4f} s, is_sat {t2 - t1:.4f} s, "
        f"{(totals['witness'] + totals['sps'] + totals['prove']) / FOLDS:.4f} s/fold  [{card}]")
    log(f"launch counts on the chain: {launches}; madd (batched, off the path): {madd_mod.madd_batch.launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the support chain")
    check(madd_mod.madd_batch.launches == 0, "the support chain still launched the per-step madd")
    inp = random_input(np.random.default_rng(SEED + 1))
    t0 = time.perf_counter()
    _, W_replay = chain.witness(inp)
    t1 = time.perf_counter()
    _, W_direct = chain.witness_direct(inp)
    t2 = time.perf_counter()
    check(same_words(W_replay, W_direct), "the support circuit's replayed witness differs from direct synthesis")
    log(f"support circuit k=14: structure and tape {t_sup:.4f} s ({tape_sizes(sup_taped)}); one witness by native "
        f"replay {t1 - t0:.4f} s, by direct synthesis {t2 - t1:.4f} s: equal word for word  [{card}]")

    # corruption probe: one flipped witness cell must be caught
    W0 = chain.acc.W.W[0].clone()
    W0[5, 0] ^= 1
    bad = RelaxedPlonkTrace(chain.acc.U, RelaxedPlonkWitness([W0, *chain.acc.W.W[1:]], chain.acc.W.E))
    bad_errors = chain.is_sat(bad)
    check(len(bad_errors) > 0, "is_sat missed a corrupted witness cell")
    log(f"corruption probe: {len(bad_errors)} error(s): {bad_errors[0]}")

    inp = random_input(rng)
    log(profiled("profiled fold", lambda: chain.fold(inp)) + f"  [{card}]")
    check(chain.is_sat() == [], "is_sat after the profiled fold")

    # ---- the Cyclefold IVC: the main path (launch counts from here) -----------------------------
    profiler.enable()
    for fn in (*counters, madd_mod.madd_batch):
        fn.launches = 0
    mk.msm_combine.shapes, mk.msm_accumulate.shapes, bucket_plan.shapes = {}, {}, {}
    fk.mul_rows.launches, fk.mul_rows.shapes = 0, {}
    t0 = time.perf_counter()
    pp = cf_pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), IVC_K, ck1, ck2)  # cf_pp: the mesh phase's too
    t1 = synced()
    reset_peaks()  # the mesh phase's baseline: this path's next seconds, spans and peak device memory
    ivc = CyclefoldIVC(pp, IVC_Z0)
    t2 = synced()
    span_seconds()
    cf_base = {"nexts": [], "spans": []}
    log(f"IVC k={IVC_K}: public parameters {t1 - t0:.4f} s (primary {pp.S_primary.num_advice_columns} advice "
        f"columns, {len(pp.S_primary.gates)} gate, W round {pp.S_primary.round_sizes[0]}; SFC tape "
        f"{tape_sizes(pp.sfc_taped)}; support tape {tape_sizes(pp.support_taped)}), new {t2 - t1:.4f} s  [{card}]")
    with last_calls(CyclefoldIVC, "_sfc_witness") as cf_calls:
        for i in range(IVC_STEPS):
            t0 = synced()
            ivc.next()
            dt = synced() - t0
            cf_base["nexts"].append(dt)
            cf_base["spans"].append(span_seconds())
            log(f"IVC next {i + 1} (step {ivc.step - 1} -> {ivc.step}): {dt:.4f} s; spans: "
                + ", ".join(f"{k} {v:.4f} s" for k, v in cf_base["spans"][-1].items()) + f"  [{card}]")
    cf_base.update(next=cf_base["nexts"][-1], peaks=card_peaks())
    t0 = synced()
    errors = ivc.verify()
    dt = synced() - t0
    check(errors == [], f"IVC verify reported {errors}")
    check(ivc.z_i == IVC_Z0 and ivc.step == IVC_STEPS + 1, f"IVC state: z_i {ivc.z_i}, step {ivc.step}")
    log(f"IVC verify: [] in {dt:.4f} s; spans: " + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items())
        + f"  [{card}]")
    ivc_launches = {fn.__name__: fn.launches for fn in counters}
    to_mont_shapes = dict(fk.mul_rows.shapes)
    combine_shapes = dict(mk.msm_combine.shapes)
    accumulate_shapes, sort_shapes = dict(mk.msm_accumulate.shapes), dict(bucket_plan.shapes)
    log(f"launch counts on the IVC path (pp, new, {IVC_STEPS} x next, verify): {ivc_launches}; madd (batched, off "
        f"the path): {madd_mod.madd_batch.launches}; msm_combine by (t, W, B): {combine_shapes}; msm_accumulate by "
        f"(curve, points, chunks): {accumulate_shapes}; bucket_plan by points: {sort_shapes}")
    for name, count in ivc_launches.items():
        check(count > 0, f"kernel {name} never launched on the IVC path")
    check(madd_mod.madd_batch.launches == 0, "the IVC path still launched the per-step madd")
    primary_acc = sum(n for (curve, _, _), n in accumulate_shapes.items() if curve == BN256_G1.spec.name)
    check(0 < primary_acc < ivc_launches["msm_accumulate"],
          f"msm_accumulate did not launch on both curves' commits: {accumulate_shapes}")
    check(sort_shapes.get(PRIMARY_W_N, 0) > 0, f"no bucket sort at the primary W commit's {PRIMARY_W_N} points")
    check(any(shape[0] == 1 for shape in combine_shapes) and any(shape[0] > 1 for shape in combine_shapes),
          f"msm_combine did not launch at both best_msm's and msm_many's shapes: {combine_shapes}")
    digests = (pg_acc_digest(AccumulatorInstance.from_acc(ivc.self_acc)), sangria_acc_digest(ivc.support_acc.U))
    log(f"IVC digests after {IVC_STEPS} steps: pg_acc_digest {digests[0]}, sangria_acc_digest {digests[1]}, pp digest "
        f"{pp.digest_hex()}")
    check(all(d.startswith(want) for d, want in zip(digests, CYCLEFOLD_DIGESTS)),
          f"the Cyclefold digests moved: {digests}, not {CYCLEFOLD_DIGESTS}...")
    cf_replay_check(f"IVC k={IVC_K} next {IVC_STEPS}", cf_calls[-1], card)

    # mul_rows K = 1 as the SPS's conversion of the replayed W to Montgomery form: the last next's W (917,504
    # standard-form words, uploaded packed) times R^2 broadcast (nb = 1), against its plain version, and equal to
    # the pending trace's W round
    W_rep = cf_calls[-1][1][0]
    words = torch.from_numpy(np.concatenate(W_rep.cols).view(np.int32)).to(dev)
    w64, r2 = words.to(torch.int64) & 0xFFFFFFFF, torch.from_numpy(ints_to_words([FR.r2])).to(dev)
    got = fk.mul_rows(FR, w64, r2)
    err = word_err([got], [fk.mul_rows_plain(FR, w64, r2)])
    check(err == 0 and torch.equal(got, ivc.primary_trace.w.W[0]) and torch.equal(FR.to_mont_words(words), got),
          "mul_rows K = 1 at the W conversion disagrees with its plain version or the pending trace's W round")
    ms = gpu_ms(lambda: fk.mul_rows(FR, w64, r2), reps=20)
    plain = gpu_ms(lambda: fk.mul_rows_plain(FR, w64, r2), reps=1)
    upload_ms = gpu_ms(lambda: torch.from_numpy(np.concatenate(W_rep.cols).view(np.int32)).to(dev), reps=5)
    record("mul_rows_to_mont", "sirius_tpu_torch/csrc/field_ops.cu", "scripts/tpu_microbench.py:74", err, ms, plain,
           PRIMARY_W_N, 2 * FE * PRIMARY_W_N + FE)
    kernels["mul_rows_to_mont"]["launches"] = to_mont_shapes.get((PRIMARY_W_N, 1), 0)
    e = kernels["mul_rows_to_mont"]
    check(e["launches"] > 0, f"no W conversion at {PRIMARY_W_N} rows on the IVC path: mul_rows by (n, nb) "
          f"{to_mont_shapes}")
    log(f"mul_rows K=1 as the W conversion ({PRIMARY_W_N} x 1, b = R^2): equals its plain version, Field.to_mont_words "
        f"and the pending trace's W round; {ms:.6f} ms, plain {plain:.4f} ms, bound {e['bound_ms']:.6f} ms "
        f"({e['bound_by']}), library: none; the packed upload (concatenate + host-to-device, "
        f"{words.numel() * 4} B) {upload_ms:.6f} ms; mul_rows launches on the IVC path by (n, nb): {to_mont_shapes}  "
        f"[{card}]")

    # corruption probe: one flipped cell of the PG accumulator's witness
    W0 = ivc.self_acc.trace.w.W[0]
    saved = W0[7].clone()
    W0[7, 0] ^= 1
    bad_errors = ivc.verify()
    W0[7] = saved
    check(any(e.startswith("pg:") for e in bad_errors), f"IVC verify missed a corrupted accumulator: {bad_errors}")
    log(f"IVC corruption probe: {len(bad_errors)} error(s): {bad_errors}")
    span_seconds()
    log(profiled("profiled next", ivc.next) + f"  [{card}]")
    check(ivc.verify() == [], "IVC verify after the profiled next")
    profiler.enabled = False

    # ---- entry points (a): checkpoint and resume on the main path ---------------------------------------------
    # the IVC to disk, resumed into a fresh object; one next on each must give the same state
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = str(Path(tmp) / "cyclefold")
        t0 = synced()
        ivc.checkpoint(path)
        t_write = synced() - t0
        t0 = synced()
        resumed = CyclefoldIVC.resume(pp, path)
        t_read = synced() - t0
        nbytes = ckpt_bytes(path)
        check(cf_digests(resumed) == cf_digests(ivc) and (resumed.step, resumed.z_i) == (ivc.step, ivc.z_i),
              "the resumed Cyclefold state differs from the checkpointed one")
        with open(path + ".json") as f:
            meta = json.load(f)
        meta["pp_digest"] = "0" * len(meta["pp_digest"])
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
        try:
            CyclefoldIVC.resume(pp, path)
            check(False, "a checkpoint with a foreign pp digest was resumed")
        except ValueError:
            pass
    t0 = synced()
    ivc.next()
    t_next = synced() - t0
    t0 = synced()
    resumed.next()
    t_resumed = synced() - t0
    digests = cf_digests(ivc)
    check(cf_digests(resumed) == digests and resumed.z_i == ivc.z_i,
          f"the resumed next differs from the uninterrupted one: {cf_digests(resumed)} against {digests}")
    errors = resumed.verify()
    check(errors == [], f"verify of the resumed IVC reported {errors}")
    log(f"checkpoint (k={IVC_K}, real keys, step {ivc.step - 1}): write {t_write:.4f} s, {nbytes} B "
        f"({nbytes / 2**20:.1f} MiB), resume {t_read:.4f} s; a foreign pp digest refused; one next on the "
        f"uninterrupted IVC {t_next:.4f} s and on the resumed one {t_resumed:.4f} s give equal digests {digests}; "
        f"verify() of the resumed IVC == []  [{card}]")
    del resumed

    # ---- B2 at the primary W commit, then S1 on its level-0 partials ------------------------------
    W = ivc.primary_trace.w.W[0]
    S = FR.from_mont(W)
    check(S.shape[0] == PRIMARY_W_N, f"the primary trace's W round holds {S.shape[0]} values")
    plan = bucket_plan(S)
    plain_plan = bucket_plan_plain(S)
    check(all(torch.equal(getattr(plan, k), getattr(plain_plan, k)) for k in PLAN_ARRAYS),
          "B2's bucket sort differs from bucket_plan_plain at the primary W commit")
    acc = (BN256_G1, plan.entries, plan.chunk_start, plan.chunk_len, ck1.points.x, ck1.points.y)
    parts = mk.msm_accumulate(*acc)
    err = word_err(parts, mk.msm_accumulate_plain(*acc))
    check(err == 0, "B2 msm_accumulate is not bit-exact against its twin at the primary W commit")
    ms_sort = gpu_ms(lambda: bucket_plan(S))
    plain_sort = gpu_ms(lambda: bucket_plan_plain(S), reps=1)
    ms_acc = gpu_ms(lambda: mk.msm_accumulate(*acc), reps=5)
    plain_acc = gpu_ms(lambda: mk.msm_accumulate_plain(*acc), reps=1)
    n_entries, n_chunks = plan.entries.shape[0], plan.chunk_start.shape[0]
    record("bucket_sort_primary", "sirius_tpu_torch/csrc/msm.cu", "sirius_tpu/ops/pallas_msm.py:50", 0, ms_sort,
           plain_sort, 0, sort_bytes(plan, PRIMARY_W_N))
    record("msm_accumulate_primary", "sirius_tpu_torch/csrc/msm.cu", "sirius_tpu/ops/pallas_msm.py:50", err, ms_acc,
           plain_acc, MADD_MULS * seeded_adds(plan.chunk_len),
           4 * n_entries + 8 * n_chunks + 2 * FE * PRIMARY_W_N + 3 * FE * n_chunks)
    b2p, sp = kernels["msm_accumulate_primary"], kernels["bucket_sort_primary"]
    log(f"B2 at the primary W commit ({PRIMARY_W_N} bn256 scalars of the IVC's last step, c={plan.c}: {n_entries} "
        f"live digits, {n_chunks} chunks): the bucket sort equals bucket_plan_plain, msm_accumulate is bit-exact; "
        f"bucket sort {ms_sort:.6f} ms (plain {plain_sort:.4f} ms, bound {sp['bound_ms']:.7f} ms, {sp['bound_by']}), "
        f"msm_accumulate {ms_acc:.6f} ms (plain {plain_acc:.4f} ms, bound {b2p['bound_ms']:.7f} ms, "
        f"{b2p['bound_by']})  [{card}]")
    longest = int((plan.seg_off[1:] - plan.seg_off[:-1]).max())
    sub_off, nxt = split_segments(plan.seg_off, FAN_IN) if longest > FAN_IN else (plan.seg_off, None)
    args = (BN256_G1, sub_off, parts)
    rolled = mk.msm_reduce_rolled(*args)
    tree = mk.msm_reduce(*args)
    check(word_err(tree, mk.msm_reduce_plain(*args)) == 0,
          "B3 msm_reduce is not bit-exact against its twin at the primary commit's level 0")
    err = point_err(BN256_G1, rolled, tree)
    check(err == 0, "S1 msm_reduce_rolled differs from msm_reduce at the primary commit's level 0")
    # unsplit: the commit's bucket segments whole, against msm_reduce's levels (the twin pads every segment to
    # the longest, a bucket of ~1,000 partials here: too large for the card's memory)
    whole = (BN256_G1, plan.seg_off, parts)
    rolled_whole = mk.msm_reduce_rolled(*whole)
    two = tree if nxt is None else mk.msm_reduce(BN256_G1, nxt, tree)
    if nxt is not None:
        check(word_err(two, mk.msm_reduce_plain(BN256_G1, nxt, tree)) == 0,
              "B3 msm_reduce is not bit-exact against its twin at the primary commit's level 1")
    check(point_err(BN256_G1, rolled_whole, two) == 0, "S1 on the unsplit segments differs from msm_reduce's levels")
    # both wrappers read the longest segment on the host each call: in turns on CUDA events (the wrappers'
    # time, S1's the kernels line's as every entry's), then each kernel's own device time (events around each
    # launch)
    mk.msm_reduce_rolled.launches = 0
    ms_ref = gpu_ms(lambda: mk.msm_reduce(*args), reps=10)
    ms_rolled = gpu_ms(lambda: mk.msm_reduce_rolled(*args), reps=10)
    ms_rolled2 = gpu_ms(lambda: mk.msm_reduce_rolled(*args), reps=10)
    ms_ref2 = gpu_ms(lambda: mk.msm_reduce(*args), reps=10)
    passes = len(mk.rolled_passes(plan.seg_off, longest))
    ms_whole = gpu_ms(lambda: mk.msm_reduce_rolled(*whole), reps=10)
    k_rolled = kernel_ms(lambda: mk.msm_reduce_rolled(*args), "sirius_msm_reduce_rolled")
    k_whole = kernel_ms(lambda: mk.msm_reduce_rolled(*whole), "sirius_msm_reduce_rolled")
    probe_launches["msm_reduce_rolled"] = mk.msm_reduce_rolled.launches
    check(probe_launches["msm_reduce_rolled"] > 0, "S1 msm_reduce_rolled never launched in its timed runs")
    k_ref = kernel_ms(lambda: mk.msm_reduce(*args), "sirius_msm_reduce")
    plain = gpu_ms(lambda: mk.msm_reduce_rolled_plain(*args), reps=1)
    n_parts, n_seg = parts.x.shape[0], sub_off.shape[0] - 1
    record("msm_reduce_rolled", "sirius_tpu_torch/csrc/msm.cu", "scripts/msm_lab2.py:18", err,
           (ms_rolled + ms_rolled2) / 2, plain,
           ADD_MULS * seeded_adds(sub_off[1:] - sub_off[:-1]), 3 * FE * n_parts + 4 * (n_seg + 1) + 3 * FE * n_seg)
    s1 = kernels["msm_reduce_rolled"]
    bound_whole, by_whole = bound(ADD_MULS * seeded_adds(plan.seg_off[1:] - plan.seg_off[:-1]),
                                  3 * FE * n_parts + 4 * plan.seg_off.shape[0] + 3 * FE * (plan.seg_off.shape[0] - 1),
                                  imad_rate)
    log(f"S1 msm_reduce_rolled on the primary commit's level 0 ({W.shape[0]} scalars, {n_parts} partials -> "
        f"{n_seg} segments of at most {FAN_IN}): equals msm_reduce and its twin in affine form, msm_reduce equals "
        f"the twin word for word; the wrappers in turns (CUDA events, each with its host read of the longest "
        f"segment) msm_reduce {ms_ref:.6f} ms, S1 {ms_rolled:.6f} ms, S1 {ms_rolled2:.6f} ms, msm_reduce "
        f"{ms_ref2:.6f} ms (S1's mean {s1['ms']:.6f} ms, the kernels line's); the kernels alone (events around "
        f"each launch) msm_reduce_kernel {k_ref:.6f} ms, msm_reduce_rolled_kernel {k_rolled:.6f} ms; plain "
        f"{plain:.4f} ms; "
        f"bound {s1['bound_ms']:.6f} ms ({s1['bound_by']})  [{card}]")
    log(f"S1 msm_reduce_rolled on the unsplit segments ({plan.seg_off.shape[0] - 1} buckets, the longest {longest} "
        f"partials, {passes} launch(es)): equals msm_reduce's levels (each word for word its twin) in affine form; "
        f"the kernels alone (events around each launch) {k_whole:.6f} ms, the wrapper {ms_whole:.6f} ms; bound "
        f"{bound_whole:.6f} ms ({by_whole})  [{card}]")
    # ---- Sangria IVC, the second IVC construction (its path: launch counts from here) -----------------
    # against the JAX package: the k = 16 run on the mock keys, on the card, equals the digests frozen from it
    t0 = time.perf_counter()
    mpp = SangriaPublicParams(TrivialStepCircuit(arity=1), TrivialStepCircuit(arity=1), SANGRIA_GOLDEN_K,
                              SANGRIA_GOLDEN_K, MockCommitmentKey(BN256_G1, dev), MockCommitmentKey(GRUMPKIN, dev))
    mivc = SangriaIVC(mpp, *SANGRIA_Z0)
    accs = lambda v: (sangria_acc_digest(v.primary_relaxed.U), sangria_acc_digest(v.secondary_relaxed.U))  # noqa: E731
    got_new = accs(mivc)
    mivc.fold_step()
    got_step = accs(mivc)
    dt = synced() - t0
    check((mpp.digest_coords(1), mpp.digest_coords(2)) == (golden.SANGRIA_IVC_K16_PP_DIGEST_1,
                                                          golden.SANGRIA_IVC_K16_PP_DIGEST_2),
          "Sangria k = 16 mock-key pp digests differ from the JAX package's frozen ones")
    check(got_new == golden.SANGRIA_IVC_K16_NEW and got_step == golden.SANGRIA_IVC_K16_STEP,
          f"Sangria k = 16 mock-key accumulators differ from the JAX package's frozen digests: {got_new} {got_step}")
    log(f"Sangria IVC k={SANGRIA_GOLDEN_K} on the mock keys, on the card: both pp digest points and both "
        f"accumulators' sangria_acc_digest after new and after one fold_step equal the JAX package's, frozen in "
        f"util/golden.py; pp + new + fold_step {dt:.4f} s  [{card}]")
    del mivc, mpp

    profiler.enable()
    span_seconds()
    for fn in (*counters, madd_mod.madd_batch):
        fn.launches = 0
    madd_mod.madd_buckets.curves, mk.msm_reduce.curves, mk.msm_combine.curves = {}, {}, {}
    mk.msm_combine.shapes, mk.msm_accumulate.shapes, bucket_plan.shapes = {}, {}, {}
    t0 = time.perf_counter()
    spp = SangriaPublicParams(TrivialStepCircuit(arity=1), TrivialStepCircuit(arity=1), SANGRIA_K, SANGRIA_K,
                              ck1, ck2)
    t1 = synced()
    sivc = SangriaIVC(spp, *SANGRIA_Z0)
    t2 = synced()
    Sp, Ss = spp.primary.S, spp.secondary.S
    log(f"Sangria IVC k={SANGRIA_K} (trivial step on both sides, bn256 2^{PRIMARY_LOG} / grumpkin "
        f"2^{GRUMPKIN_KEY_LOG} keys): public parameters {t1 - t0:.4f} s (primary {Sp.num_advice_columns} advice "
        f"columns, W round {Sp.round_sizes[0]}, {spp.primary_num_cross_terms} cross terms, "
        f"{spp.primary_probe.num_challenges} challenges, tape {tape_sizes(spp.primary.taped)}; secondary "
        f"{Ss.num_advice_columns} columns, W round {Ss.round_sizes[0]}, {spp.secondary_num_cross_terms} cross terms, "
        f"tape {tape_sizes(spp.secondary.taped)}), new {t2 - t1:.4f} s; spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    # the first step's cross terms (both curves) are kept for the walk's checks below
    captured = []
    cross_terms_fn = VanillaFS.commit_cross_terms

    def recording(ck, *args):
        out = cross_terms_fn(ck, *args)
        captured.append((ck, out))
        return out

    VanillaFS.commit_cross_terms = staticmethod(recording)
    with last_calls(SangriaIVC, "_witness", keep=2) as sg_calls:  # the last step's primary and secondary SFC
        for i in range(SANGRIA_STEPS):
            t0 = synced()
            sivc.fold_step()
            dt = synced() - t0
            VanillaFS.commit_cross_terms = staticmethod(cross_terms_fn)
            log(f"Sangria fold_step {i + 1} (step {sivc.step - 1} -> {sivc.step}): {dt:.4f} s; spans: "
                + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    t0 = synced()
    errors = sivc.verify()
    dt = synced() - t0
    check(errors == [], f"Sangria verify reported {errors}")
    check(sivc.step == SANGRIA_STEPS + 1 and (sivc.primary_z_i, sivc.secondary_z_i) == SANGRIA_Z0,
          f"Sangria state: step {sivc.step}, z_i {sivc.primary_z_i} / {sivc.secondary_z_i}")
    log(f"Sangria verify: [] in {dt:.4f} s; spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    sangria_launches = {fn.__name__: fn.launches for fn in counters}
    by_curve = {"madd_buckets": dict(madd_mod.madd_buckets.curves), "msm_reduce": dict(mk.msm_reduce.curves),
                "msm_combine": dict(mk.msm_combine.curves)}
    s_accumulate, s_sort = dict(mk.msm_accumulate.shapes), dict(bucket_plan.shapes)
    log(f"launch counts on the Sangria path (pp, new, {SANGRIA_STEPS} x fold_step, verify): {sangria_launches}; "
        f"madd (batched, off the path): {madd_mod.madd_batch.launches}; by curve {by_curve}; msm_accumulate by "
        f"(curve, points, chunks): {s_accumulate}; bucket_plan by points: {s_sort}; msm_combine by (t, W, B): "
        f"{dict(mk.msm_combine.shapes)}")
    for name, count in sangria_launches.items():
        check(count > 0, f"kernel {name} never launched on the Sangria path")
    check(madd_mod.madd_batch.launches == 0, "the Sangria path launched the batched madd")
    for curve in (BN256_G1, GRUMPKIN):
        name = curve.spec.name
        for kernel, counts in by_curve.items():
            check(counts.get(name, 0) > 0, f"{kernel} never launched on {name} on the Sangria path")
        check(any(c == name and n == PRIMARY_W_N for c, n, _ in s_accumulate),
              f"msm_accumulate never ran a {PRIMARY_W_N}-point W commit on {name}: {s_accumulate}")
    check(s_sort.get(PRIMARY_W_N, 0) >= 2, f"the bucket sort did not run both sides' W commits: {s_sort}")
    check(any(shape[0] == CROSS_TERMS for shape in mk.msm_combine.shapes), "no msm_many combine on the Sangria path")
    log(f"Sangria digests after {SANGRIA_STEPS} steps: sangria_acc_digest primary {accs(sivc)[0]}, secondary "
        f"{accs(sivc)[1]}; pp digests {spp.digest_coords(1)} / {spp.digest_coords(2)}")
    sg_replay_check(f"Sangria k={SANGRIA_K} fold_step {SANGRIA_STEPS}", sg_calls, card)

    # corruption probe: one flipped cell of the primary accumulator's witness
    W0 = sivc.primary_relaxed.W.W[0]
    saved = W0[7].clone()
    W0[7, 0] ^= 1
    bad_errors = sivc.verify()
    W0[7] = saved
    check(any(e.startswith("primary:") for e in bad_errors), f"Sangria verify missed a flipped cell: {bad_errors}")
    log(f"Sangria corruption probe: {len(bad_errors)} error(s): {bad_errors}")
    span_seconds()
    log(profiled("profiled fold_step", sivc.fold_step) + f"  [{card}]")
    log("profiled fold_step spans: " + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()))
    check(sivc.verify() == [], "Sangria verify after the profiled fold_step")
    profiler.enabled = False

    # entry points (a): the primary relaxed accumulator saved and loaded back onto the card, keyed by digest_1
    acc = sivc.primary_relaxed
    digest_hex = "".join(f"{v:064x}" for v in spp.digest_coords(1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = str(Path(tmp) / "sangria")
        t0 = synced()
        save_sangria_accumulator(path, bn256_g1, acc, digest_hex, sivc.step)
        t_write = synced() - t0
        t0 = synced()
        loaded, step = load_sangria_accumulator(path, digest_hex, device=dev)
        t_read = synced() - t0
        nbytes = ckpt_bytes(path)
        try:
            load_sangria_accumulator(path, "0" * len(digest_hex), device=dev)
            check(False, "a Sangria accumulator was loaded under a foreign pp digest")
        except ValueError:
            pass
    check(step == sivc.step and sangria_acc_digest(loaded.U) == sangria_acc_digest(acc.U),
          "the loaded Sangria accumulator's instance differs from the saved one")
    check(all(a.device == dev and torch.equal(a, b) for a, b in zip([*loaded.W.W, loaded.W.E], [*acc.W.W, acc.W.E])),
          "the loaded Sangria accumulator's W / E words differ on the card")
    log(f"Sangria accumulator (primary, k={SANGRIA_K}): saved in {t_write:.4f} s ({nbytes} B), loaded onto the card "
        f"in {t_read:.4f} s: sangria_acc_digest {sangria_acc_digest(loaded.U)} and every W and E word equal; a "
        f"foreign pp digest refused  [{card}]")
    del loaded, acc

    # the walk at the Sangria path's shape, (5, 2^17), on each curve: the first step's cross terms
    check(sorted(ck.curve.spec.name for ck, _ in captured) == ["bn256_g1", "grumpkin"],
          f"the first fold_step's cross terms: {[ck.curve.spec.name for ck, _ in captured]}")
    for ck, (terms, commits) in captured:
        curve = ck.curve
        name = curve.spec.name
        t, n = len(terms), terms[0].shape[0]
        check((t, n) == SANGRIA_CROSS, f"the {name} cross terms are {(t, n)}, not {SANGRIA_CROSS}")
        Sx = curve.fs.from_mont(torch.stack(terms))
        pts = Points(*(c[:n] for c in ck.points))
        walk = (curve, Sx, pts.x.contiguous(), pts.y.contiguous(), MANY_GROUPS, MANY_WINDOW_BITS)
        table = madd_mod.madd_buckets(*walk)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        plain_table = madd_mod.madd_buckets_plain(*walk)
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end)  # one call: the twin walks 2^17 / 256 steps
        err = word_err(table, plain_table)
        check(err == 0, f"B1 madd_buckets is not bit-exact against its twin at {SANGRIA_CROSS} on {name}")
        del plain_table
        many = msm_many(curve, Sx, pts)
        best = [best_msm(curve, Sx[i], pts) for i in range(t)]
        check(many == best == list(commits), f"msm_many at {SANGRIA_CROSS} on {name} differs from best_msm or the "
              f"step's cross-term commits")
        ms = gpu_ms(lambda: madd_mod.madd_buckets(*walk), reps=5)
        many_ms = gpu_ms(lambda: msm_many(curve, Sx, pts), reps=5)
        best_ms = gpu_ms(lambda: [best_msm(curve, Sx[i], pts) for i in range(t)], reps=5)
        dg = madd_mod.extract_digits(Sx, MANY_WINDOW_BITS).reshape(t, -1, MANY_GROUPS, n // MANY_GROUPS)
        B_many = (1 << MANY_WINDOW_BITS) - 1
        live = int((dg > 0).sum())
        touched = sum(int((dg == v).any(-1).sum()) for v in range(1, B_many + 1))
        entry = f"madd_buckets_sangria_{name}"
        record(entry, "sirius_tpu_torch/csrc/madd.cu", "sirius_tpu/ops/pallas_madd.py:136", err, ms, plain,
               MADD_MULS * (live - touched), FE * t * n + 2 * FE * n + 3 * FE * t * dg.shape[1] * B_many * MANY_GROUPS)
        kernels[entry]["launches"] = by_curve["madd_buckets"][name]
        e = kernels[entry]
        log(f"B1 madd_buckets at the Sangria cross terms {SANGRIA_CROSS} on {name} ({n // MANY_GROUPS} points a "
            f"lane at G = {MANY_GROUPS}; {live} live digits, {touched} buckets touched): bit-exact against its twin; "
            f"kernel {ms:.6f} ms, plain {plain:.4f} ms (one call), bound {e['bound_ms']:.6f} ms ({e['bound_by']}); "
            f"msm_many (walk, reduce, combine) {many_ms:.6f} ms, best_msm on the same five vectors {best_ms:.6f} ms; "
            f"msm_many equals best_msm and the step's commits  [{card}]")

    # B2 at grumpkin's 917,504-point W commit (the secondary trace's)
    Sg = GRUMPKIN.fs.from_mont(sivc.secondary_trace.w.W[0])
    check(Sg.shape[0] == PRIMARY_W_N, f"the secondary trace's W round holds {Sg.shape[0]} values")
    plan = bucket_plan(Sg)
    plain_plan = bucket_plan_plain(Sg)
    check(all(torch.equal(getattr(plan, k), getattr(plain_plan, k)) for k in PLAN_ARRAYS),
          "B2's bucket sort differs from bucket_plan_plain at grumpkin's W commit")
    acc = (GRUMPKIN, plan.entries, plan.chunk_start, plan.chunk_len, ck2.points.x, ck2.points.y)
    err = word_err(mk.msm_accumulate(*acc), mk.msm_accumulate_plain(*acc))
    check(err == 0, "B2 msm_accumulate is not bit-exact against its twin at grumpkin's W commit")
    ms_acc = gpu_ms(lambda: mk.msm_accumulate(*acc), reps=5)
    plain_acc = gpu_ms(lambda: mk.msm_accumulate_plain(*acc), reps=1)
    n_entries, n_chunks = plan.entries.shape[0], plan.chunk_start.shape[0]
    record("msm_accumulate_sangria_grumpkin", "sirius_tpu_torch/csrc/msm.cu", "sirius_tpu/ops/pallas_msm.py:50", err,
           ms_acc, plain_acc, MADD_MULS * seeded_adds(plan.chunk_len),
           4 * n_entries + 8 * n_chunks + 2 * FE * PRIMARY_W_N + 3 * FE * n_chunks)
    kernels["msm_accumulate_sangria_grumpkin"]["launches"] = sum(
        n for (c, pts_n, _), n in s_accumulate.items() if c == GRUMPKIN.spec.name and pts_n == PRIMARY_W_N)
    e = kernels["msm_accumulate_sangria_grumpkin"]
    log(f"B2 at grumpkin's W commit ({PRIMARY_W_N} Fq scalars of the Sangria secondary trace, c={plan.c}: "
        f"{n_entries} live digits, {n_chunks} chunks): the bucket sort equals bucket_plan_plain, msm_accumulate is "
        f"bit-exact; msm_accumulate {ms_acc:.6f} ms (plain {plain_acc:.4f} ms, bound {e['bound_ms']:.7f} ms, "
        f"{e['bound_by']})  [{card}]")
    del sivc, spp, captured

    # ---- the lookup path: the 2- and 3-round SPS, Sangria and ProtoGalaxy over lookup traces ----------------
    # against the JAX package: the K = 5 traces of tests/test_lookup.py, on the card, equal the digests frozen from it
    t0 = time.perf_counter()
    small_ck = CommitmentKey.setup(BN256_G1, LOOKUP_GOLDEN_KEY_LOG, b"lookup-test", use_cache=False, device=dev)
    for circuit, frozen in ((RangeCircuit([3, 7, 15, 0, 1, 1, 5]), golden.LOOKUP_RANGE_K5_TRACE),
                            (VectorRangeCircuit([2, 3, 5, 7, 11]), golden.LOOKUP_VECTOR_K5_TRACE)):
        runner = CircuitRunner(LOOKUP_GOLDEN_K, bn256_fr, circuit, circuit.instances())
        tr = run_sps_protocol(runner.collect_plonk_structure(), small_ck, circuit.instances(),
                              runner.collect_witness(), lookup_ro())
        got = golden.plonk_trace_digest([w.cpu().numpy() for w in tr.w.W], tr.u)
        check(got == frozen, f"the K = {LOOKUP_GOLDEN_K} {type(circuit).__name__} trace on the card differs from the "
              f"JAX package's frozen digest: {got}")
    log(f"lookup traces at K = {LOOKUP_GOLDEN_K} (tests/test_lookup.py's RangeCircuit, 2 rounds, and "
        f"VectorRangeCircuit, 3 rounds) on the card: every W round's words, the commitments and the challenges equal "
        f"the JAX package's digests frozen in util/golden.py ({synced() - t0:.2f} s)  [{card}]")
    del small_ck

    n = 1 << LOOKUP_K
    lrng = np.random.default_rng(SEED + LOOKUP_K)
    draws = [lrng.integers(0, LOOKUP_TABLE, size=n).tolist() for _ in range(2)]
    cases = [("range: scalar lookup, 2 rounds", "m_count", [RangeCircuit(v, LOOKUP_K, LOOKUP_TABLE) for v in draws],
              (0, 7, LOOKUP_TABLE)),
             ("fibo-xor: vector lookup, 3 rounds", "m_count_vector",
              [FiboXorLookupCircuit(a, b, n, LOOKUP_XOR_BITS) for a, b in ((1, 2), (3, 5))], (2, 5, None))]
    for label, entry, circuits, (col, row, value) in cases:
        profiler.enable()
        span_seconds()
        for fn in (*counters, madd_mod.madd_batch, lookup_kernels.m_count):
            fn.launches = 0
        secs = {}
        t0 = synced()
        runners = [CircuitRunner(LOOKUP_K, bn256_fr, c, c.instances()) for c in circuits]
        S = runners[0].collect_plonk_structure()
        witnesses = [r.collect_witness() for r in runners]
        secs["synthesis (2 traces)"] = synced() - t0
        traces = []
        for i, (c, w) in enumerate(zip(circuits, witnesses)):
            t0 = synced()
            traces.append(run_sps_protocol(S, ck1, c.instances(), w, lookup_ro()))
            secs[f"sps {i + 1}"] = synced() - t0
        tr1, tr2 = traces
        check(lookup_kernels.m_count.launches == 2, f"{label}: m_count launched {lookup_kernels.m_count.launches} "
              f"times in two SPS runs")
        t0 = synced()
        satisfy.is_sat(S, ck1, lookup_ro(), tr1.u, tr1.w)
        secs["is_sat"] = synced() - t0
        # one changed advice value: its row leaves the table, and the log-derivative sums differ
        bad = [list(c) for c in witnesses[0]]
        bad[col][row] = value if value is not None else bad[col][row] ^ 1
        tr_bad = run_sps_protocol(S, ck1, circuits[0].instances(), bad, lookup_ro())
        check(not satisfy.is_sat_log_derivative(S, tr_bad.w), f"{label}: a changed advice value passed the "
              f"log-derivative check")
        # Sangria: the relaxed first trace folds the second
        acc = RelaxedPlonkTrace(RelaxedPlonkInstance.from_instance(bn256_g1, tr1.u),
                                RelaxedPlonkWitness.from_regular(tr1.w, LOOKUP_K, S.field))
        pp, vp = VanillaFS.setup_params(gold.identity(bn256_g1), S)
        t0 = synced()
        s_acc, cts = VanillaFS.prove(ck1, pp, lookup_ro(), acc, tr2)
        secs["sangria prove"] = synced() - t0
        t0 = synced()
        s_ver = VanillaFS.verify(vp, bn256_g1, lookup_ro(), lookup_ro(), acc.U, tr2.u, cts)
        secs["sangria verify"] = synced() - t0
        check(s_ver == s_acc.U, f"{label}: Sangria verify differs from the prover's instance")
        t0 = synced()
        errors = VanillaFS.is_sat(ck1, S, s_acc, [tr1.u.instances, tr2.u.instances])
        secs["sangria is_sat"] = synced() - t0
        check(errors == [], f"{label}: Sangria is_sat reported {errors}")
        # ProtoGalaxy, L = 1
        gpp, gvp = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
        t0 = synced()
        g_acc = ProtoGalaxy.new_accumulator(gpp, pg_ro(), tr1, bn256_g1)
        secs["protogalaxy new"] = synced() - t0
        t0 = synced()
        g_new, proof = ProtoGalaxy.prove(ck1, gpp, pg_ro(), g_acc, [tr2])
        secs["protogalaxy prove"] = synced() - t0
        t0 = synced()
        g_ver = ProtoGalaxy.verify(gvp, bn256_fr, lookup_ro(), pg_ro(), AccumulatorInstance.from_acc(g_acc),
                                   [tr2.u], proof)
        secs["protogalaxy verify"] = synced() - t0
        check(g_ver == AccumulatorInstance.from_acc(g_new), f"{label}: ProtoGalaxy verify differs from the prover's "
              f"instance")
        t0 = synced()
        errors = ProtoGalaxy.is_sat(ck1, S, g_new)
        secs["protogalaxy is_sat"] = synced() - t0
        check(errors == [], f"{label}: ProtoGalaxy is_sat reported {errors}")
        spans = span_seconds()
        profiler.enabled = False
        path = {fn.__name__: fn.launches for fn in (*counters, lookup_kernels.m_count)}
        for name, count in path.items():
            check(count > 0, f"kernel {name} never launched on the lookup path ({label})")
        check(madd_mod.madd_batch.launches == 0, f"the lookup path ({label}) launched the batched madd")
        log(f"lookups k={LOOKUP_K}, {label} (W rounds {S.round_sizes}, {S.num_challenges} challenges, "
            f"{S.get_degree_for_folding() - 1} Sangria cross terms): "
            + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items()) + "; spans: "
            + ", ".join(f"{k} {v:.4f} s" for k, v in spans.items()) + f"; launch counts {path}  [{card}]")
        log(f"  Sangria: verify equals the prover's instance, is_sat []; ProtoGalaxy L = 1: verify equals the "
            f"prover's instance, is_sat []; a changed advice value (column {col}, row {row}) fails the log-derivative "
            f"check; digests: sangria_acc_digest {sangria_acc_digest(s_ver)}, pg_acc_digest {pg_acc_digest(g_ver)}")

        # the kernel against its plain version on the path's l and t (trace 1's), timed
        W_lt = tr1.w.W[1] if S.has_vector_lookup() else tr1.w.W[0]
        off = 0 if S.has_vector_lookup() else S.num_advice_columns * n
        l, t, m = (W_lt[off + i * n : off + (i + 1) * n] for i in range(3))
        got = lookup_kernels.m_count(l, t)
        want = m_count_plain(l, t)
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"m_count disagrees with m_count_plain on the {label} path's l and t")
        std = FR.from_mont(m)
        check(bool((std[:, 0] == got.to(torch.int64)).all() and (std[:, 1:] == 0).all()),
              f"the {label} trace's m column is not the kernel's counts")
        ms, extra = graph_ms(lambda: lookup_kernels.m_count(l, t), launches=50)
        back_to_back = gpu_ms(lambda: lookup_kernels.m_count(l, t), reps=20)
        plain = gpu_ms(lambda: m_count_plain(l, t), reps=3)
        cap = lookup_kernels.table_capacity(n)
        record(entry, "sirius_tpu_torch/csrc/lookup.cu", "sirius_tpu/plonk/lookup.py:54", err, ms, plain, 0,
               2 * FE * n + 4 * cap + 4 * n)
        kernels[entry]["launches"] = path["m_count"]
        e = kernels[entry]
        distinct = int((want > 0).sum())
        log(f"m_count (csrc/lookup.cu; no Pallas counterpart: the JAX package's jitted sort, "
            f"sirius_tpu/plonk/lookup.py:54) on the {label} path's l and t ({n} rows each, {distinct} table rows "
            f"earn counts, {int(want.sum())} of {n} l rows hit; table {cap} slots): equals m_count_plain and the "
            f"trace's m column; {ms:.6f} ms a call from a CUDA graph of its launches (its insert and probe, and the "
            f"table's and counts' fills), {back_to_back:.6f} ms back to back, plain {plain:.4f} ms, bound "
            f"{e['bound_ms']:.7f} ms ({e['bound_by']}: 2 x {n} x 32 B read, {4 * cap} B of table, {4 * n} B of "
            f"counts), library: none; launches on its path {path['m_count']}  [{card}]")

    # ---- lookup step circuits through both IVC drivers, led by the SHA-256 Cyclefold at its production size ------
    # a. the XOR-lookup step (3 W rounds: 3 support folds a next) through Cyclefold at k = 18 on the mock keys, on
    # the card, against the JAX package's digests frozen in util/golden.py
    t0 = synced()
    xpp = CyclefoldPublicParams(XorLookupStepCircuit(key=3), XOR_LOOKUP_K, MockCommitmentKey(BN256_G1, dev),
                                MockCommitmentKey(GRUMPKIN, dev))
    check(xpp.digest_hex() == golden.CYCLEFOLD_XOR_LOOKUP_K18_PP, f"the XOR-lookup Cyclefold pp digest on the card "
          f"differs from the JAX package's: {xpp.digest_hex()}")
    xivc = CyclefoldIVC(xpp, XOR_LOOKUP_Z0)
    check(cf_digests(xivc) == golden.CYCLEFOLD_XOR_LOOKUP_K18_NEW,
          f"the XOR-lookup Cyclefold after new differs from the JAX package's digests: {cf_digests(xivc)}")
    xivc.next()
    check(xivc.z_i == [XOR_LOOKUP_Z0[0] ^ 3 ^ 3] and xivc.step == 2, f"XOR-lookup Cyclefold state: z_i {xivc.z_i}")
    check(cf_digests(xivc) == golden.CYCLEFOLD_XOR_LOOKUP_K18_NEXT,
          f"the XOR-lookup Cyclefold after next differs from the JAX package's digests: {cf_digests(xivc)}")
    errors = xivc.verify()
    check(errors == [], f"XOR-lookup Cyclefold verify reported {errors}")
    log(f"Cyclefold XorLookupStepCircuit(key=3) k={XOR_LOOKUP_K} on the mock keys (W rounds "
        f"{xpp.S_primary.round_sizes}, {xpp.num_challenges_primary} challenges): pp, new, next, verify() == [] in "
        f"{synced() - t0:.2f} s; z = {xivc.z_i}; the pp digest and, after new and after next, the ProtoGalaxy and "
        f"support accumulators' and the pending trace's digests equal the JAX package's frozen in util/golden.py  "
        f"[{card}]")
    del xivc, xpp

    # b. the production SHA-256: SpreadSha256StepCircuit (H = 16, 64 rounds) through Cyclefold at k = 18 on the
    # bn256 2^22 key and the support key (launch counts from here)
    profiler.enable()
    span_seconds()
    for fn in (*counters, madd_mod.madd_batch, lookup_kernels.m_count):
        fn.launches = 0
    mk.msm_combine.shapes, mk.msm_accumulate.shapes, bucket_plan.shapes = {}, {}, {}
    sha = SpreadSha256StepCircuit(bn256_fr, half_bits=SHA_HALF_BITS, rounds=SHA_ROUNDS)
    t0 = synced()
    spp = CyclefoldPublicParams(sha, SHA_K, ck1_full, ck2)
    dt = synced() - t0
    sizes = spp.S_primary.round_sizes
    check(sizes == SHA_ROUND_SIZES and spp.num_witness_primary == 3 and spp.num_challenges_primary == 3,
          f"the SHA-256 primary's shape: W rounds {sizes}, {spp.num_challenges_primary} challenges")
    check(len(ck1_full) == 1 << max(sizes).bit_length() - 1, f"the bn256 key ({len(ck1_full)} points) is not the "
          f"largest W round {max(sizes)} rounded up to a power of two")
    log(f"SHA-256 Cyclefold k={SHA_K} (SpreadSha256StepCircuit H={SHA_HALF_BITS}, {SHA_ROUNDS} rounds): public "
        f"parameters {dt:.4f} s; num_witness_primary {spp.num_witness_primary}, W rounds {sizes}, "
        f"{spp.S_primary.num_advice_columns} advice columns, {spp.num_challenges_primary} challenges, "
        f"{len(spp.S_primary.gates)} gates; SFC tape {tape_sizes(spp.sfc_taped)} (the replay's slots "
        f"{136 * spp.sfc_taped.tape.n_slots} B); spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    def peak() -> str:  # the stage's peak device memory (the keys' stay allocated), then reset
        torch.cuda.synchronize()
        b = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return f"peak device memory {b} B ({b / 2**30:.3f} GiB, the keys' {resident} B included)"

    resident = torch.cuda.memory_allocated()
    peak()
    t0 = synced()
    sivc = CyclefoldIVC(spp, SHA_Z0)
    dt = synced() - t0
    z = sha256_step_fn(SHA_Z0[0], bn256_fr.modulus)
    check(sivc.z_i == [z], f"SHA-256 Cyclefold new: z {sivc.z_i} is not step_fn's {z}")
    log(f"SHA-256 Cyclefold new: {dt:.4f} s, z = {hex(z)} (step_fn); {peak()}; spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    with last_calls(CyclefoldIVC, "_sfc_witness") as sha_calls:
        for i in range(SHA_STEPS):
            t0 = synced()
            if i < SHA_STEPS - 1:
                sivc.next()
                line = f"{synced() - t0:.4f} s"
            else:  # the last next under torch.profiler
                line = profiled("next", sivc.next)
            z = sha256_step_fn(z, bn256_fr.modulus)
            check(sivc.z_i == [z], f"SHA-256 Cyclefold next {i + 1}: z {sivc.z_i} is not step_fn's {z}")
            log(f"SHA-256 Cyclefold next {i + 1} (step {sivc.step - 1} -> {sivc.step}): {line}; z = {hex(z)} "
                f"(step_fn); {peak()}; spans: " + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items())
                + f"  [{card}]")
    t0 = synced()
    errors = sivc.verify()
    dt = synced() - t0
    check(errors == [], f"SHA-256 Cyclefold verify reported {errors}")
    log(f"SHA-256 Cyclefold verify: [] in {dt:.4f} s; {peak()}; spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    sha_launches = {fn.__name__: fn.launches for fn in (*counters, lookup_kernels.m_count)}
    sha_combine, sha_accumulate, sha_sort = dict(mk.msm_combine.shapes), dict(mk.msm_accumulate.shapes), dict(
        bucket_plan.shapes)
    log(f"launch counts on the SHA-256 path (pp, new, {SHA_STEPS} x next, verify): {sha_launches}; madd (batched, "
        f"off the path): {madd_mod.madd_batch.launches}; msm_combine by (t, W, B): {sha_combine}; msm_accumulate by "
        f"(curve, points, chunks): {sha_accumulate}; bucket_plan by points: {sha_sort}")
    for name, count in sha_launches.items():
        check(count > 0, f"kernel {name} never launched on the SHA-256 path")
    check(madd_mod.madd_batch.launches == 0, "the SHA-256 path launched the batched madd")
    check(sha_sort.get(SHA_ROUND_SIZES[0], 0) > 0, f"no bucket sort at the SHA-256 W commit's {SHA_ROUND_SIZES[0]} "
          f"points")
    log(f"SHA-256 Cyclefold digests after {SHA_STEPS} steps (pg, support, pending trace): {cf_digests(sivc)}, pp "
        f"digest {spp.digest_hex()}")
    cf_replay_check(f"SHA-256 Cyclefold k={SHA_K} next {SHA_STEPS}", sha_calls[-1], card)
    del sha_calls
    # corruption probe: one flipped advice cell of the pending trace
    W0 = sivc.primary_trace.w.W[0]
    saved = W0[7].clone()
    W0[7, 0] ^= 1
    bad_errors = sivc.verify()
    W0[7] = saved
    check(bad_errors != [], "SHA-256 Cyclefold verify missed a flipped advice cell of the pending trace")
    log(f"SHA-256 Cyclefold corruption probe (advice cell 7 of the pending trace): {len(bad_errors)} error(s): "
        f"{bad_errors}")
    span_seconds()
    profiler.enabled = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:  # entry points (a) on the SHA-256 state
        path = str(Path(tmp) / "sha256")
        t0 = synced()
        sivc.checkpoint(path)
        t_write = synced() - t0
        t0 = synced()
        resumed = CyclefoldIVC.resume(spp, path)
        t_read = synced() - t0
        nbytes = ckpt_bytes(path)
    check(cf_digests(resumed) == cf_digests(sivc) and resumed.z_i == sivc.z_i,
          "the resumed SHA-256 Cyclefold state differs from the checkpointed one")
    log(f"checkpoint of the SHA-256 Cyclefold state (k={SHA_K}, step {sivc.step}): write {t_write:.4f} s, {nbytes} B "
        f"({nbytes / 2**20:.1f} MiB), resume {t_read:.4f} s, the digests equal  [{card}]")
    del resumed

    # B2/B3 at the path's largest W commit (the pending trace's advice round: 4,194,304 bn256 scalars), every stage
    # against its twin and the result against the trace's commitment
    W0 = sivc.primary_trace.w.W[0]
    n = W0.shape[0]
    pts = Points(*(c[:n] for c in ck1_full.points))
    res, stage, plan = msm_stages(BN256_G1, FR.from_mont(W0), pts, timed=True)
    check(BN256_G1.decode(res)[0] == sivc.primary_trace.u.W_commitments[0],
          "B2/B3 stages at the SHA-256 W commit disagree with the trace's commitment")
    plan_bytes = {k: getattr(plan, k).numel() * getattr(plan, k).element_size() for k in PLAN_ARRAYS}
    for name, (err, ms, plain, muls, nbytes) in stage.items():
        if name in ("bucket_sort", "msm_accumulate", "msm_reduce", "msm_combine"):
            record(f"{name}_sha256", "sirius_tpu_torch/csrc/msm.cu",
                   "sirius_tpu/ops/pallas_msm.py:50" if name in B2_NAMES else "sirius_tpu/ops/pallas_msm.py:173",
                   err, ms, plain, muls, nbytes)
    kernels["bucket_sort_sha256"]["launches"] = sha_sort[n]
    kernels["msm_accumulate_sha256"]["launches"] = sum(
        k for (c, pts_n, _), k in sha_accumulate.items() if c == BN256_G1.spec.name and pts_n == n)
    kernels["msm_reduce_sha256"]["launches"] = sha_launches["msm_reduce"]
    kernels["msm_combine_sha256"]["launches"] = sum(k for shape, k in sha_combine.items() if shape[0] == 1)
    log(f"B2/B3 at the SHA-256 W commit ({n} bn256 scalars, c={plan.c}, W={plan.W}, B={plan.B}: "
        f"{plan.entries.shape[0]} live digits, {plan.chunk_start.shape[0]} chunks; the plan's arrays {plan_bytes} B): "
        f"every stage agrees with its twin and the result with the trace's commitment; "
        + ", ".join(f"{k} {v[1]:.6f} ms (plain {v[2]:.4f} ms, bound {kernels[k + '_sha256']['bound_ms']:.7f} ms, "
                    f"{kernels[k + '_sha256']['bound_by']})" for k, v in stage.items() if k + "_sha256" in kernels)
        + f"  [{card}]")

    # m_count at the sink-heavy shape: the pending trace's (dense, spread) lookup, nearly every row the (0, 0) sink
    n = 1 << SHA_K
    l, t = sivc.primary_trace.w.W[1][0:n], sivc.primary_trace.w.W[1][n : 2 * n]
    got = lookup_kernels.m_count(l, t)
    want = m_count_plain(l, t)
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, "m_count disagrees with m_count_plain on the SHA-256 path's l and t")
    ms, extra = graph_ms(lambda: lookup_kernels.m_count(l, t), launches=50)
    back_to_back = gpu_ms(lambda: lookup_kernels.m_count(l, t), reps=20)
    plain = gpu_ms(lambda: m_count_plain(l, t), reps=3)
    cap = lookup_kernels.table_capacity(n)
    record("m_count_sha256", "sirius_tpu_torch/csrc/lookup.cu", "sirius_tpu/plonk/lookup.py:54", err, ms, plain, 0,
           2 * FE * n + 4 * cap + 4 * n)
    kernels["m_count_sha256"]["launches"] = sha_launches["m_count"]
    e = kernels["m_count_sha256"]
    log(f"m_count on the SHA-256 path's (dense, spread) l and t ({n} rows each; {int((want > 0).sum())} table rows "
        f"earn counts, the (0, 0) sink {int(want[0])} of them): equals m_count_plain; {ms:.6f} ms a call from a CUDA "
        f"graph, {back_to_back:.6f} ms back to back, plain {plain:.4f} ms, bound {e['bound_ms']:.7f} ms "
        f"({e['bound_by']}), library: none; launches on its path {sha_launches['m_count']}  [{card}]")
    del sivc, spp, l, t, W0, pts, plan

    # c. Sangria IVC over the range step (byte lookups: a 2-round SPS) at k = 17 on both curves: the primary on the
    # bn256 2^22 key (its first W round, 2,359,296 scalars, fits no smaller power of two), the secondary on the
    # grumpkin 2^20 key (launch counts from here)
    profiler.enable()
    span_seconds()
    for fn in (*counters, madd_mod.madd_batch, lookup_kernels.m_count):
        fn.launches = 0
    t0 = synced()
    rpp = SangriaPublicParams(RangeCheckStepCircuit(bn256_fr), TrivialStepCircuit(arity=1), RANGE_K, RANGE_K,
                              ck1_full, ck2)
    dt = synced() - t0
    probe = rpp.primary_probe
    check((probe.num_challenges, probe.num_witness) == (2, 2), f"the range primary's shape: {probe}")
    t0 = synced()
    rivc = SangriaIVC(rpp, *RANGE_Z0)
    z = rpp.primary_sc.process_step(RANGE_Z0[0], RANGE_K, bn256_fr)[0]  # new takes the first step
    check(rivc.primary_z_i == [z], f"Sangria range new: z {rivc.primary_z_i}, want {z}")
    log(f"Sangria IVC RangeCheckStepCircuit / TrivialStepCircuit(1) k={RANGE_K}: public parameters {dt:.4f} s "
        f"(primary W rounds {rpp.primary.S.round_sizes}, {probe.num_challenges} challenges, {probe.num_cross_terms} "
        f"cross terms), new {synced() - t0:.4f} s; spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    for i in range(RANGE_STEPS):
        t0 = synced()
        rivc.fold_step()
        dt = synced() - t0
        z = rpp.primary_sc.process_step([z], RANGE_K, bn256_fr)[0]
        check(rivc.primary_z_i == [z], f"Sangria range fold_step {i + 1}: z {rivc.primary_z_i}, want {z}")
        log(f"Sangria range fold_step {i + 1}: {dt:.4f} s; spans: "
            + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"  [{card}]")
    t0 = synced()
    errors = rivc.verify()
    dt = synced() - t0
    check(errors == [], f"Sangria range verify reported {errors}")
    range_launches = {fn.__name__: fn.launches for fn in (*counters, lookup_kernels.m_count)}
    log(f"Sangria range verify: [] in {dt:.4f} s; spans: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in span_seconds().items()) + f"; launch counts on its path (pp, new, "
        f"{RANGE_STEPS} x fold_step, verify): {range_launches}; madd (batched): {madd_mod.madd_batch.launches}  "
        f"[{card}]")
    for name, count in range_launches.items():
        check(count > 0, f"kernel {name} never launched on the Sangria range path")
    check(madd_mod.madd_batch.launches == 0, "the Sangria range path launched the batched madd")
    profiler.enabled = False
    del rivc, rpp

    # ---- the mesh phase: the multi-device path on a virtual mesh of cuda:0 and, on a multi-card host, every card -----
    mesh_phase(record, kernels, card, (ck1_full, ck1, ck2), cf_pp, rng, base=cf_base)

    # ---- phase 14: the ring ops' kernels, and their launches on the benchmark configurations' traced nexts ----------
    field_ops_phase(record, kernels, card, rng, {("bn256", PRIMARY_LOG): ck1, ("bn256", PRIMARY_KEY_LOG): ck1_full,
                                                 ("grumpkin", SUPPORT_KEY_LOG): CommitmentKey(GRUMPKIN, sup, ck2.label,
                                                                                              SUPPORT_KEY_LOG)})

    # ---- entry points (b): the Merkle example at the reference's size, and the CLI as a user runs it ----------------
    # the SFC over the Merkle step commits 14 advice columns x 2^17 = 1,835,008 scalars: more than a 2^20 key holds
    # (the JAX example's k + 3; its real-key run raises TooLongInput), so the bn256 key is the 2^22 one
    for batch in MERKLE_BATCHES:
        args = merkle_tree.parser().parse_args(["--batch", str(batch)])  # depth 32, k = 17, Cyclefold, one next
        profiler.enable()
        for fn in (*counters, madd_mod.madd_batch):
            fn.launches = 0
        resident = torch.cuda.memory_allocated()
        with last_calls(CyclefoldIVC, "_sfc_witness") as m_calls:
            mivc, r = merkle_tree.run(args, keys=(ck1_full, ck2, "real"))  # its peak device memory and spans in r
        profiler.enabled = False
        merkle_launches = {fn.__name__: fn.launches for fn in counters}
        check(r["errors"] == [], f"Merkle batch {batch}: verify reported {r['errors']}")
        check(mivc.step == 2 and mivc.z_i == [mivc.pp.sc.tree.root], f"Merkle batch {batch}: state {mivc.step}")
        for name, count in merkle_launches.items():
            check(count > 0, f"kernel {name} never launched on the Merkle path (batch {batch})")
        check(madd_mod.madd_batch.launches == 0, "the Merkle path launched the batched madd")
        log(f"Merkle example (examples/merkle_tree.run: depth {args.depth}, batch {batch}, {args.driver}, "
            f"k={args.k}, the bn256 2^{PRIMARY_KEY_LOG} and support keys; W round {mivc.pp.S_primary.round_sizes[0]}): "
            f"pp {r['pp_s']:.4f} s, new {r['new_s']:.4f} s, next {r['next_s'][0]:.4f} s, verify() == [] in "
            f"{r['verify_s']:.4f} s; peak device memory {r['peak_bytes']} B ({r['peak_bytes'] / 2**30:.3f} GiB, "
            f"{resident} B resident before); spans: " + ", ".join(f"{k} {v:.4f} s" for k, v in r["spans"].items())
            + f"; launch counts (pp, new, next, verify): {merkle_launches}; SFC tape {tape_sizes(mivc.pp.sfc_taped)}"
            f"  [{card}]")
        cf_replay_check(f"Merkle batch {batch} next", m_calls[-1], card)
        del mivc, m_calls
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "sirius_tpu_torch.examples.cli", *CLI_ARGV], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    dt = time.perf_counter() - t0
    lines = cli.stdout.strip().splitlines()
    check(cli.returncode == 0 and lines and lines[-1].endswith("OK"),
          f"the CLI {CLI_ARGV} exited {cli.returncode}: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    log(f"CLI `python3 -m sirius_tpu_torch.examples.cli {' '.join(CLI_ARGV)}` (a process of its own, its own "
        f"labelled keys): exit 0 in {dt:.1f} s; its output: " + " | ".join(lines) + f"  [{card}]")

    for name, attrs_of in [(k, mk.msm_kernel_attrs) for k in mk.MSM_KERNELS] + [
            (k, madd_mod.madd_kernel_attrs) for k in madd_mod.MADD_KERNELS]:
        attrs = attrs_of(name)
        attrs["sassInstructions"] = (sum(sum(v.values()) for k, v in sass.items() if re.search(rf"\d{name}_kernel", k))
                                     if sass else "not measured")
        log(f"{name}: {attrs}")
    for name in ntt_kernels.KERNELS:  # csrc/ntt.cu col_ntt_kernel<2, MID>: a column of 1024
        attrs = ntt_kernels.col_ntt_kernel_attrs(name)
        tag = "ILi2ELb1E" if name == "col_ntt_mid" else "ILi2ELb0E"
        attrs["sassInstructions"] = (sum(sum(v.values()) for k, v in sass.items() if f"col_ntt_kernel{tag}" in k)
                                     if sass else "not measured")
        log(f"{name}: {attrs}")
    attrs = fk.mul_rows_kernel_attrs()  # csrc/field_ops.cu mul_rows_kernel<2, false, true, 0>
    attrs["sassInstructions"] = (sum(sum(v.values()) for k, v in sass.items()
                                     if "mul_rows_kernelILi2ELb0ELb1ELi0E" in k) if sass else "not measured")
    log(f"mul_rows (the NTT path's K = 1 instance: 2 elements a thread, rep 1, the modulo, unrolled product): "
        f"{attrs}")
    for i, product in enumerate(fk.PRODUCTS):  # csrc/field_ops.cu mul_rows_kernel<1, false, false, i>: S2's
        ops = sum((v for k, v in (sass or {}).items() if f"mul_rows_kernelILi1ELb0ELb0ELi{i}E" in k), Counter())
        imads = {op: v for op, v in ops.items() if op.startswith("IMAD")}
        muls = sum(v for op, v in imads.items() if not op.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL")))
        wide = sum(v for op, v in imads.items() if op.startswith("IMAD.WIDE"))
        iadd3 = sum(v for op, v in ops.items() if op.startswith("IADD3"))
        log(f"SASS of mul_rows at K > 1 (S2's instance, one product in the K loop) on the {product} product: "
            + (f"{sum(ops.values())} instructions, {muls} integer multiplies (IMAD-class less moves, adds, "
               f"shifts), {wide} IMAD.WIDE, {iadd3} IADD3; IMAD-class by opcode {dict(sorted(imads.items()))}"
               if ops else "not measured"))

    for (op, fixed), ops in raw_sass.items():  # csrc/microbench.cu raw_u32_kernel<OP, FIXED>: S3's chains
        form = ("64 reps, straight-line: 4 chains x 64 and the ragged tail's one chain of 64" if fixed else
                "other reps: a loop of the 64-rep body, a remainder step, for the 4 chains and the tail's one")
        log(f"SASS of raw_u32 {op} ({form}): "
            + (f"{sum(ops.values())} instructions, {ops.get(opcode[op], 0)} {opcode[op]}; by opcode "
               f"{dict(sorted(ops.items()))}" if ops else "not measured"))
    kernels["madd_buckets"]["launches"] = ivc_launches["madd_buckets"]
    for key in ("msm_reduce", "msm_window_sums"):
        kernels[key]["launches"] = ivc_launches[key]
    kernels["msm_accumulate"]["launches"] = ivc_launches["msm_accumulate"] - primary_acc
    kernels["msm_accumulate_primary"]["launches"] = primary_acc
    kernels["bucket_sort_primary"]["launches"] = sort_shapes[PRIMARY_W_N]
    kernels["bucket_sort"]["launches"] = ivc_launches["bucket_plan"] - sort_shapes[PRIMARY_W_N]
    kernels["msm_combine"]["launches"] = sum(n for shape, n in combine_shapes.items() if shape[0] == 1)
    kernels["msm_combine_many"]["launches"] = sum(n for shape, n in combine_shapes.items() if shape[0] > 1)
    for name in ("col_ntt", "col_ntt_mid", "mul_rows"):
        kernels[name]["launches"] = ntt_launches[name]
    for name, count in probe_launches.items():
        check(count > 0, f"{name} never launched in its timed runs")
        kernels[name]["launches"] = count
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, the build included")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(device_json())
    return 0


if __name__ == "__main__":
    modes = {"--mesh-only": mesh_only, "--field-ops": field_ops_only}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] else main())
