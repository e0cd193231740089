"""sirius_tpu_torch — the PyTorch + CUDA port of `sirius_tpu`.

The JAX package `sirius_tpu` stays the reference; this package mirrors its
sub-layout and module names so each counterpart is easy to find:

  fields/   limbed Montgomery field arithmetic over (..., 8) int64 word tensors
  curves/   Jacobian point arithmetic, hash-to-curve
  ops/      MSM and NTT (hand-written CUDA kernels + plain torch twins),
            field-rate probes, commitments, Poseidon transcript, kernel build
  csrc/     CUDA C++ sources (sm_90a), built with nvcc at first use
  poly/     gate-expression IR and its row-parallel evaluator
  plonk/    structure, SPS protocol, evaluation domains, satisfaction checks
  frontend/ constraint-system builder and circuit runner
  gadgets/  MainGate and the EC chip
  ivc/      the Cyclefold support circuit and support-fold chain
  nifs/     Sangria folding
  util/     numpy/torch interop, device default, transcript RO, test doubles

It imports `torch` and nothing of `jax` or `sirius_tpu`: the host-only
modules it shares with the JAX package (constants, gold model, expression
IR, circuit builder, gadgets, support circuit) are its own copies.  Every
entry point that takes a `device` runs on the CUDA device when none is
given, and raises where there is no CUDA.
"""

__version__ = "0.1.0"
